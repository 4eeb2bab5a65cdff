"""SE(3) / SO(3) Lie-group operations on torch tensors.

Port of ``tpu_slam.core.se3``: poses are (..., 4, 4) homogeneous matrices,
tangent vectors are (..., 6) vectors ``xi = [v, w]`` (translation first).
Every function takes any number of leading batch dimensions, so one call
serves one pose or a batch of them (pose-graph edges, loop pairs) where the
reference uses ``jax.vmap``. The small-angle and near-pi branches are the
reference's, evaluated branch-free with ``torch.where`` so no value is read
back to the host.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _sq_norm(w: torch.Tensor) -> torch.Tensor:
    return (w * w).sum(-1)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector: hat(w) @ x == cross(w, x)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, numerically safe at ||w|| -> 0."""
    theta2 = _sq_norm(w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    a = torch.sin(theta) / theta
    b = (1.0 - torch.cos(theta)) / (theta * theta)
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, a)[..., None, None]
    b = torch.where(small, 0.5 - theta2 / 24.0, b)[..., None, None]
    return _eye(3, w) + a * W + b * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of a rotation matrix -> rotation vector (axis * angle)."""
    trace = torch.clamp(torch.diagonal(R, dim1=-2, dim2=-1).sum(-1),
                        -1.0, 3.0)
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    w_raw = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_t = torch.sin(theta)

    one = torch.ones_like(sin_t)
    generic = (0.5 * theta / torch.where(sin_t.abs() < _EPS, one, sin_t)
               )[..., None] * w_raw
    small = (0.5 * (1.0 + theta * theta / 6.0))[..., None] * w_raw
    # near pi: axis from the diagonal of (R + I) / 2, signs from the
    # off-diagonals relative to the largest axis component
    diag = torch.clamp((torch.diagonal(R, dim1=-2, dim2=-1) + 1.0) * 0.5,
                       0.0, 1.0)
    axis_abs = torch.sqrt(diag)
    k = torch.argmax(axis_abs, dim=-1)
    s01 = torch.sign(R[..., 0, 1] + R[..., 1, 0])
    s02 = torch.sign(R[..., 0, 2] + R[..., 2, 0])
    s12 = torch.sign(R[..., 1, 2] + R[..., 2, 1])
    signs_by_k = torch.stack([
        torch.stack([one, s01, s02], -1),
        torch.stack([s01, one, s12], -1),
        torch.stack([s02, s12, one], -1),
    ], -2)                                               # (..., 3, 3)
    idx = k[..., None, None].expand(*k.shape, 1, 3)
    signs = torch.gather(signs_by_k, -2, idx).squeeze(-2)
    signs = torch.where(signs == 0.0, torch.ones_like(signs), signs)
    near_pi = theta[..., None] * signs * axis_abs / torch.clamp(
        torch.linalg.vector_norm(axis_abs, dim=-1, keepdim=True), min=_EPS)

    w = torch.where((theta < 1e-4)[..., None], small, generic)
    w = torch.where((theta > math.pi - 1e-3)[..., None], near_pi, w)
    return w.to(R.dtype)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3); the V matrix of the SE(3) exp map."""
    theta2 = _sq_norm(w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    b = (1.0 - torch.cos(theta)) / (theta * theta)
    c = (theta - torch.sin(theta)) / (theta * theta * theta)
    small = theta2 < 1e-12
    b = torch.where(small, 0.5 - theta2 / 24.0, b)[..., None, None]
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, c)[..., None, None]
    return _eye(3, w) + b * W + c * (W @ W)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------

def from_rt(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) from rotations (..., 3, 3) and translations (..., 3)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    T = torch.nn.functional.pad(top, (0, 0, 0, 1))
    T[..., 3, 3] = 1.0
    return T


def exp(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map. xi = [v(3), w(3)] -> 4x4 homogeneous matrix."""
    v, w = xi[..., :3], xi[..., 3:]
    return from_rt(so3_exp(w), (so3_left_jacobian(w) @ v[..., None])[..., 0])


def log(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map. 4x4 matrix -> xi = [v, w]."""
    w = so3_log(T[..., :3, :3])
    V = so3_left_jacobian(w)
    # solve_ex: no error check, so no host synchronisation on CUDA (V is
    # well conditioned for every rotation angle below 2 pi)
    v = torch.linalg.solve_ex(V, T[..., :3, 3])[0]
    return torch.cat([v, w], dim=-1)


def inverse(T: torch.Tensor) -> torch.Tensor:
    Rt = T[..., :3, :3].transpose(-1, -2)
    return from_rt(Rt, (-Rt @ T[..., :3, 3:])[..., 0])


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def orthonormalize(T: torch.Tensor) -> torch.Tensor:
    """Project the rotation block back onto SO(3) (one polar-Newton step).

    R <- R (3 I - R^T R) / 2 removes the first-order scale and skew that
    repeated float32 compositions accumulate.
    """
    R = T[..., :3, :3]
    R = 0.5 * (R @ (3.0 * _eye(3, T) - R.transpose(-1, -2) @ R))
    return from_rt(R, T[..., :3, 3])


def apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) transforms to (..., N, 3) point arrays."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def retract(T: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative retraction: exp(xi) @ T (the GN update rule)."""
    return exp(xi) @ T


# ---------------------------------------------------------------------------
# Adjoints (pose-graph Jacobian machinery)
# ---------------------------------------------------------------------------

def adjoint(T: torch.Tensor) -> torch.Tensor:
    """SE(3) adjoint, 6x6, for xi = [v, w] ordering:

        Ad(T) = [[R, hat(t) R], [0, R]]   with   Ad(T) xi = log(T exp(xi) T^-1)
    """
    R = T[..., :3, :3]
    top = torch.cat([R, hat(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def ad(xi: torch.Tensor) -> torch.Tensor:
    """se(3) small adjoint: ad(xi) = [[hat(w), hat(v)], [0, hat(w)]]."""
    W = hat(xi[..., 3:])
    top = torch.cat([W, hat(xi[..., :3])], dim=-1)
    bot = torch.cat([torch.zeros_like(W), W], dim=-1)
    return torch.cat([top, bot], dim=-2)


def left_jacobian_inv_approx(xi: torch.Tensor) -> torch.Tensor:
    """Second-order approximation of the inverse SE(3) left Jacobian:
    J_l^{-1}(xi) ~= I - ad(xi)/2 + ad(xi)^2/12 (truncation error
    O(|xi|^4), below what GN on pose-graph residuals resolves)."""
    A = ad(xi)
    return _eye(6, xi) - 0.5 * A + (1.0 / 12.0) * (A @ A)
