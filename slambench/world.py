"""The benchmark's general scan generator: worlds, routes and sensors.

A configuration names its world (``"world": {"kind": <name>, ...}``) and
its sensor (``"sensor": {"model": <name>, ...}``); a traffic mix names its
route (``"route": {"shape": <name>, ...}``). Each name is a file of its
own, found by ``slambench.plugins``: ``worlds/<kind>.py`` (``patches(**kw)``:
the planar patches, each an origin corner and two edge vectors),
``routes/<shape>.py`` (``poses(n, **kw)``: (n, 4, 4) sensor poses) and
``sensors/<model>.py`` (``scans(patches, poses, sensor, seed, device)``:
every pose's scan on the device). The rest of each object is that file's
parameters.

The pieces here are shared by those files, copied from
``tpu_slam_torch.ingest.synthetic`` and rewritten so that a cell's scans
are ray-cast in a few large batches on the device: ``raycast`` (every ray
against every patch, the nearest hit kept) and ``ring_scans`` (a spinning
multi-ring LiDAR). The range noise is one fixed draw (``torch.Generator``
on the device, the sensor's ``noise_seed``); the run's seed orders each
scan's returns. So every seed drives the same scans, sizes and motion,
handed over in another order.
"""

from __future__ import annotations

import math
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from slambench import plugins

PAD_COORD = 1.0e8

Patch = Tuple[np.ndarray, np.ndarray, np.ndarray]    # origin corner, u, v


def make_world(spec: Dict, root: Optional[pathlib.Path] = None
               ) -> List[Patch]:
    kw = {k: v for k, v in spec.items() if k != "kind"}
    return plugins.load("worlds", spec["kind"], root).patches(**kw)


def make_route(spec: Dict, n: int, root: Optional[pathlib.Path] = None
               ) -> np.ndarray:
    kw = {k: v for k, v in spec.items() if k != "shape"}
    return plugins.load("routes", spec["shape"], root).poses(n, **kw)


def make_scans(patches: List[Patch], poses: np.ndarray, sensor: Dict,
               seed: int, device, root: Optional[pathlib.Path] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    return plugins.load("sensors", sensor["model"], root).scans(
        patches, poses, sensor, seed, device)


def box(lo, hi) -> List[Patch]:
    """The six faces of an axis-aligned box (``make_room``'s order)."""
    e = np.array
    lo, hi = np.asarray(lo, float), np.asarray(hi, float)
    d = hi - lo
    return [
        (lo, e([d[0], 0, 0]), e([0, d[1], 0])),
        (e([lo[0], lo[1], hi[2]]), e([d[0], 0, 0]), e([0, d[1], 0])),
        (lo, e([d[0], 0, 0]), e([0, 0, d[2]])),
        (e([lo[0], hi[1], lo[2]]), e([d[0], 0, 0]), e([0, 0, d[2]])),
        (lo, e([0, d[1], 0]), e([0, 0, d[2]])),
        (e([hi[0], lo[1], lo[2]]), e([0, d[1], 0]), e([0, 0, d[2]])),
    ]


def se2_pose(x: float, y: float, yaw: float, z: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T[:3, 3] = [x, y, z]
    return T


def ring_directions(n_azimuth: int, elevations_deg: Sequence[float]
                    ) -> np.ndarray:
    """(n_azimuth * rings, 3) unit ray directions of one revolution,
    azimuth-major, the rings in ``elevations_deg``'s order."""
    az = np.linspace(0.0, 2 * np.pi, n_azimuth, endpoint=False)
    el = np.radians(np.asarray(elevations_deg, np.float64))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    ce = np.cos(elg)
    return np.stack([ce * np.cos(azg), ce * np.sin(azg), np.sin(elg)],
                    axis=-1).reshape(-1, 3)


def raycast(patches: List[Patch], origins: torch.Tensor,
            dirs: torch.Tensor) -> torch.Tensor:
    """Nearest hit parameter of each ray, inf where no patch is hit.

    origins (B, 3), dirs (B, R, 3) world frame, float32 on one device.
    ``synthetic._raycast_program``'s algebra, one origin a batch row.
    """
    dev = dirs.device
    f32 = dict(dtype=torch.float32, device=dev)
    o = torch.tensor(np.stack([p[0] for p in patches]), **f32)
    u = torch.tensor(np.stack([p[1] for p in patches]), **f32)
    v = torch.tensor(np.stack([p[2] for p in patches]), **f32)
    n = torch.linalg.cross(u, v)
    n = n / torch.linalg.vector_norm(n, dim=1, keepdim=True)
    uu, vv = (u * u).sum(1), (v * v).sum(1)
    inf = torch.tensor(math.inf, **f32)
    denom = dirs @ n.T                                    # (B, R, K)
    rel = o[None] - origins[:, None, :]                   # (B, K, 3)
    num = (rel * n[None]).sum(-1)[:, None, :]
    t = num / denom
    t = torch.where(denom.abs() < 1e-9, inf, t)
    t = torch.where(t <= 1e-6, inf, t)
    a = (-(rel * u[None]).sum(-1)[:, None, :] + t * (dirs @ u.T)) / uu
    b = (-(rel * v[None]).sum(-1)[:, None, :] + t * (dirs @ v.T)) / vv
    inside = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    return torch.where(inside, t, inf).min(dim=-1).values


def ring_scans(patches: List[Patch], poses: np.ndarray, sensor: Dict,
               seed: int, device, elevations_deg: Sequence[float],
               batch_rays: int = 1 << 24
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pose's revolution of a spinning LiDAR with a ring at each of
    ``elevations_deg`` and ``sensor['n_azimuth']`` azimuths, sensor frame,
    on ``device``.

    Returns (points (N, C, 3) float32, mask (N, C) bool): each scan's
    valid returns first, padded to ``sensor['capacity']`` rows at
    PAD_COORD. A return is valid when the ray hits within [min_range,
    max_range]; Gaussian range noise of ``noise_std`` is added to it from
    a generator seeded with ``sensor['noise_seed']``, the same for every
    run, as the source's numpy ``default_rng(0)`` is. The run's ``seed``
    orders each scan's valid returns (a permutation from it), so every
    seed hands over the same points of the same scans, in another order.
    Poses are cast ``batch_rays`` ray-patch pairs at a time.
    """
    dev = torch.device(device)
    dirs_s64 = torch.tensor(ring_directions(sensor["n_azimuth"],
                                            elevations_deg),
                            dtype=torch.float64, device=dev)
    dirs_s = dirs_s64.to(torch.float32)
    n_rays = dirs_s.shape[0]
    cap = sensor["capacity"]
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(sensor["noise_seed"]))
    order_gen = torch.Generator(device=dev)
    order_gen.manual_seed(int(seed) % (1 << 63))
    T = torch.tensor(poses, dtype=torch.float64, device=dev)
    per = max(1, batch_rays // (n_rays * len(patches)))
    pts_out = torch.full((len(poses), cap, 3), PAD_COORD,
                         dtype=torch.float32, device=dev)
    msk_out = torch.zeros((len(poses), cap), dtype=torch.bool, device=dev)
    keep = min(cap, n_rays)
    for s in range(0, len(poses), per):
        Tb = T[s:s + per]
        dirs_w = (dirs_s64 @ Tb[:, :3, :3].transpose(1, 2)).to(torch.float32)
        r = raycast(patches, Tb[:, :3, 3].to(torch.float32), dirs_w)
        r = torch.where(r <= sensor["max_range"], r, math.inf)
        valid = torch.isfinite(r) & (r >= sensor.get("min_range", 0.4))
        noise = torch.randn(r.shape, generator=noise_gen, device=dev,
                            dtype=torch.float32) * sensor["noise_std"]
        pts = dirs_s[None] * torch.where(valid, r + noise, 0.0)[..., None]
        # valid returns first, in the order the seed draws
        rank = torch.rand(r.shape, generator=order_gen, device=dev)
        order = torch.argsort(torch.where(valid, rank, 2.0), dim=1)
        order = order[:, :keep]
        kept = torch.gather(valid, 1, order)
        pts_out[s:s + per, :keep] = torch.where(
            kept[..., None],
            torch.gather(pts, 1, order[..., None].expand(-1, -1, 3)),
            PAD_COORD)
        msk_out[s:s + per, :keep] = kept
    return pts_out, msk_out
