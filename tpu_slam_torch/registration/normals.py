"""Per-point surface normals from k-NN covariance.

Port of ``tpu_slam.registration.normals``: each point's k nearest
neighbours from the Gram-form distance matrix (one (P, P) matrix product,
cheap at keyframe sizes), their covariance, and its smallest eigenvector.
Runs once per keyframe at store time. The normal's sign is arbitrary:
point-to-plane residuals and Jacobians do not depend on it.
"""

from __future__ import annotations

import torch

from tpu_slam_torch.core.pointcloud import PAD_COORD


def estimate_normals(points: torch.Tensor, mask: torch.Tensor,
                     k: int = 16) -> torch.Tensor:
    """(P, 3) unit normals from each point's k-NN covariance.

    Invalid points (mask False) sit at PAD_COORD and never enter a valid
    point's neighbourhood; their own normals are (0, 0, 1).
    """
    pts = torch.where(mask[:, None], points, PAD_COORD)
    sq = torch.sum(pts * pts, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (pts @ pts.T)
    idx = torch.topk(-d2, k, dim=1).indices          # (P, k) incl. self
    nbr = pts[idx]                                   # (P, k, 3)
    c = nbr - nbr.mean(dim=1, keepdim=True)
    cov = torch.einsum("pki,pkj->pij", c, c) / k
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    # padded/degenerate neighbourhoods get an identity-ish covariance so
    # eigh stays finite
    cov = cov + 1e-12 * eye
    cov = torch.where(torch.isfinite(cov), cov, eye)
    vecs = torch.linalg.eigh(cov).eigenvectors       # ascending eigenvalues
    nrm = vecs[:, :, 0]
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=1,
                                                     keepdim=True), min=1e-12)
    up = torch.zeros(3, dtype=nrm.dtype, device=nrm.device)
    up[2] = 1.0
    return torch.where(mask[:, None], nrm, up)
