"""Synthetic LiDAR worlds and the VLP-16 sensor simulation.

Copy of the parts of ``tpu_slam.ingest.synthetic`` the ported slices
need: planar-patch worlds with vectorized ray casting, surface sampling
(the config-3 map), the VLP-16 ring model, its range images and pcap
capture, the planar line scanner and the rotating-unit capture, the
office, grid-city, outdoor-block and ring-corridor worlds, and the
corridor and loop routes. The numpy chunk path is the
reference's, unchanged, so small scenes are bit-identical to it; the large
single-origin ray-plane pass runs the same algebra in torch on the given
device (CUDA by default): the reference's jitted ``run``, on the card one
CUDA graph for each (rays, patches, device), its inputs copied into the
graph's and the ranges read back once (``compiled=False``: the same pass
eagerly, the same bits).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_slam_torch.core.consts import const
from tpu_slam_torch.utils.capture import compiled_call


@dataclasses.dataclass
class Patch:
    """A finite planar rectangle: origin corner + two edge vectors."""

    origin: np.ndarray   # (3,)
    u: np.ndarray        # (3,) first edge (full length)
    v: np.ndarray        # (3,) second edge

    @property
    def normal(self) -> np.ndarray:
        n = np.cross(self.u, self.v)
        return n / np.linalg.norm(n)


@dataclasses.dataclass
class World:
    """A collection of planar patches with vectorized ray casting."""

    patches: List[Patch]

    def _arrays(self):
        o = np.stack([p.origin for p in self.patches])       # (K, 3)
        u = np.stack([p.u for p in self.patches])
        v = np.stack([p.v for p in self.patches])
        n = np.cross(u, v)
        n = n / np.linalg.norm(n, axis=1, keepdims=True)
        return o, u, v, n

    def raycast(self, origins: np.ndarray, dirs: np.ndarray,
                max_range: float = 130.0, device=None,
                compiled: bool = True) -> np.ndarray:
        """Cast rays; returns (N,) ranges, inf where nothing was hit.

        origins: (N, 3), dirs: (N, 3) unit vectors, world frame. Large
        single-origin workloads (>= 4M ray-patch pairs) run one torch pass
        on ``device`` (``compiled``: a graph replay on the card, module
        docstring); the rest run chunked float32 numpy.
        """
        o, u, v, n = (a.astype(np.float32) for a in self._arrays())
        uu = np.sum(u * u, axis=1)
        vv = np.sum(v * v, axis=1)
        N = dirs.shape[0]
        out = np.empty(N, np.float32)
        chunk = 8192
        same_origin = (origins.ndim == 2
                       and np.all(origins[0] == origins[-1]))
        if same_origin and N * len(self.patches) >= 4_000_000:
            return _raycast_accel(o, u, v, n, uu.astype(np.float32),
                                  vv.astype(np.float32),
                                  origins[0].astype(np.float32),
                                  dirs.astype(np.float32),
                                  float(max_range), device, compiled)
        for s in range(0, N, chunk):
            d = dirs[s:s + chunk].astype(np.float32)
            og = origins[s:s + chunk].astype(np.float32)
            denom = d @ n.T                                 # (C, K)
            num = (np.sum((o - og[0]) * n, axis=1)[None, :]
                   if same_origin else np.sum(
                       (o[None, :, :] - og[:, None, :]) * n[None, :, :],
                       axis=2))
            with np.errstate(divide="ignore", invalid="ignore"):
                t = num / denom
            t = np.where(np.abs(denom) < 1e-9, np.inf, t)
            t = np.where(t <= 1e-6, np.inf, t)
            with np.errstate(invalid="ignore"):
                hit = og[:, None, :] + t[..., None] * d[:, None, :]
                rel = hit - o[None, :, :]                    # (C, K, 3)
                a = np.sum(rel * u[None, :, :], axis=2) * (1.0 / uu)
                b = np.sum(rel * v[None, :, :], axis=2) * (1.0 / vv)
            inside = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
            t = np.where(inside, t, np.inf)
            out[s:s + chunk] = np.min(t, axis=1)
        return np.where(out <= max_range, out, np.inf).astype(np.float32)


# the ray caster's graphs, one for each (rays, patches, device)
_raycasts: Dict = {}


def _raycast_program(o, u, v, n, uu, vv, origin, dirs):
    """The single-origin pass: (N,) the nearest hit's parameter, inf where
    no patch is hit. Reads nothing back.

    With t the plane-hit parameter, the patch coordinates are
    a = (ou + t*du)/uu (and likewise b), where ou/du are dot products, so
    everything is (N, K) element-wise math plus three small matmuls.
    """
    inf = const(math.inf, torch.float32, dirs.device)
    denom = dirs @ n.T                                  # (N, K)
    num = torch.sum((o - origin) * n, dim=1)[None, :]
    t = num / denom
    t = torch.where(denom.abs() < 1e-9, inf, t)
    t = torch.where(t <= 1e-6, inf, t)
    du = dirs @ u.T
    dv = dirs @ v.T
    ou = torch.sum((origin - o) * u, dim=1)[None, :]
    ov = torch.sum((origin - o) * v, dim=1)[None, :]
    a = (ou + t * du) / uu[None, :]
    b = (ov + t * dv) / vv[None, :]
    inside = (a >= 0) & (a <= 1) & (b >= 0) & (b <= 1)
    t = torch.where(inside, t, inf)
    return torch.min(t, dim=1).values


def _raycast_accel(o, u, v, n, uu, vv, origin, dirs, max_range, device,
                   compiled=True):
    """Single-origin ray-plane intersection as one torch pass on
    ``device`` (``_raycast_program``), the ranges read back once."""
    from tpu_slam_torch import default_device

    dev = default_device(device)
    args = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                 for x in (o, u, v, n, uu, vv, origin, dirs))
    t = (compiled_call(_raycasts, _raycast_program, args) if compiled
         else _raycast_program(*args))
    out = t.cpu().numpy()
    return np.where(out <= max_range, out, np.inf).astype(np.float32)


def sample_world_surface(world: World, spacing: float = 0.15,
                         noise_std: float = 0.01, seed: int = 0
                         ) -> np.ndarray:
    """Uniformly sample every patch surface at ~``spacing`` meters (numpy,
    the reference's draws in its order): surface points with the planar
    statistics of a raycast map, at a fraction of the cost."""
    rng = np.random.default_rng(seed)
    out = []
    for p in world.patches:
        lu = float(np.linalg.norm(p.u))
        lv = float(np.linalg.norm(p.v))
        nu = max(1, int(lu / spacing))
        nv = max(1, int(lv / spacing))
        a = (np.arange(nu) + rng.uniform(0, 1, nu)) / nu
        b = (np.arange(nv) + rng.uniform(0, 1, nv)) / nv
        g = a[:, None, None] * p.u[None, None, :] \
            + b[None, :, None] * p.v[None, None, :] + p.origin
        pts = g.reshape(-1, 3)
        if noise_std > 0:
            pts = pts + rng.normal(0, noise_std, pts.shape)
        out.append(pts.astype(np.float32))
    return np.concatenate(out, axis=0)


def make_room(size: Tuple[float, float, float] = (10.0, 8.0, 3.0),
              center: Tuple[float, float] = (0.0, 0.0),
              boxes: Optional[Sequence[Tuple[np.ndarray, np.ndarray]]] = None
              ) -> World:
    """Rectangular room (floor, ceiling, 4 walls) + optional interior boxes.

    ``boxes``: sequence of (min_corner (3,), max_corner (3,)).
    """
    sx, sy, sz = size
    cx, cy = center
    x0, x1 = cx - sx / 2, cx + sx / 2
    y0, y1 = cy - sy / 2, cy + sy / 2
    e = np.array

    patches = [
        Patch(e([x0, y0, 0.0]), e([sx, 0, 0]), e([0, sy, 0])),   # floor
        Patch(e([x0, y0, sz]), e([sx, 0, 0]), e([0, sy, 0])),    # ceiling
        Patch(e([x0, y0, 0.0]), e([sx, 0, 0]), e([0, 0, sz])),   # wall y0
        Patch(e([x0, y1, 0.0]), e([sx, 0, 0]), e([0, 0, sz])),   # wall y1
        Patch(e([x0, y0, 0.0]), e([0, sy, 0]), e([0, 0, sz])),   # wall x0
        Patch(e([x1, y0, 0.0]), e([0, sy, 0]), e([0, 0, sz])),   # wall x1
    ]
    for lo, hi in (boxes or []):
        lo, hi = np.asarray(lo, float), np.asarray(hi, float)
        d = hi - lo
        patches += [
            Patch(lo, e([d[0], 0, 0]), e([0, d[1], 0])),
            Patch(e([lo[0], lo[1], hi[2]]), e([d[0], 0, 0]), e([0, d[1], 0])),
            Patch(lo, e([d[0], 0, 0]), e([0, 0, d[2]])),
            Patch(e([lo[0], hi[1], lo[2]]), e([d[0], 0, 0]), e([0, 0, d[2]])),
            Patch(lo, e([0, d[1], 0]), e([0, 0, d[2]])),
            Patch(e([hi[0], lo[1], lo[2]]), e([0, d[1], 0]), e([0, 0, d[2]])),
        ]
    return World(patches)


def default_office() -> World:
    """A structured indoor scene with enough geometry to constrain 6 DoF."""
    return make_room(
        size=(14.0, 10.0, 3.0),
        boxes=[
            (np.array([2.0, 2.0, 0.0]), np.array([3.2, 3.4, 1.2])),
            (np.array([-4.0, -3.0, 0.0]), np.array([-2.5, -1.8, 2.0])),
            (np.array([3.5, -3.5, 0.0]), np.array([5.0, -2.0, 0.9])),
        ])


VLP16_ELEVATIONS_DEG = np.array(
    [-15, 1, -13, 3, -11, 5, -9, 7, -7, 9, -5, 11, -3, 13, -1, 15],
    dtype=np.float64)


def vlp16_directions(n_azimuth: int = 900) -> np.ndarray:
    """(n_azimuth*16, 3) unit ray directions of one VLP-16 revolution."""
    az = np.linspace(0.0, 2 * np.pi, n_azimuth, endpoint=False)
    el = np.radians(VLP16_ELEVATIONS_DEG)
    azg, elg = np.meshgrid(az, el, indexing="ij")
    ce = np.cos(elg)
    return np.stack([ce * np.cos(azg), ce * np.sin(azg), np.sin(elg)],
                    axis=-1).reshape(-1, 3)


def scan_directions_2d(n_beams: int, fov_deg: float = 270.0) -> np.ndarray:
    """Beam directions of a planar scanner in its own frame (xy-plane):
    beam i at angle_min + i*step, x = cos, y = sin (the aggregator's
    polar->cartesian expansion, m3d_aggregator.cpp:269-286)."""
    half = math.radians(fov_deg) / 2
    ang = np.linspace(-half, half, n_beams, dtype=np.float64)
    return np.stack([np.cos(ang), np.sin(ang), np.zeros(n_beams)], axis=1)


def simulate_line_scan(world: World, T_world_sensor: np.ndarray,
                       n_beams: int = 541, fov_deg: float = 270.0,
                       max_range: float = 100.0,
                       noise_std: float = 0.0,
                       rng: Optional[np.random.Generator] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """One 2D scan line: (points_sensor (N, 3) f32, valid (N,) bool)."""
    dirs_s = scan_directions_2d(n_beams, fov_deg)
    R, t = T_world_sensor[:3, :3], T_world_sensor[:3, 3]
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(t, dirs_w.shape)
    r = world.raycast(origins, dirs_w, max_range)
    valid = np.isfinite(r)
    if noise_std > 0 and rng is not None:
        r = r + rng.normal(0.0, noise_std, r.shape)
    pts = dirs_s * np.where(valid, r, 0.0)[:, None]
    return pts.astype(np.float32), valid


@dataclasses.dataclass
class RotatingCapture:
    """One rotating-unit capture: the inputs a ScanAggregator consumes."""

    line_points: np.ndarray      # (L, B, 3) float32, sensor frame
    line_valid: np.ndarray       # (L, B) bool
    line_transforms: np.ndarray  # (L, 4, 4) float32 base<-sensor
    encoder_angles: np.ndarray   # (L,) float32


def simulate_rotating_capture(world: World, chain,
                              T_world_base: np.ndarray,
                              n_lines: int = 180,
                              sweep_rad: float = 1.2 * math.pi,
                              n_beams: int = 541,
                              fov_deg: float = 270.0,
                              noise_std: float = 0.0,
                              rng: Optional[np.random.Generator] = None
                              ) -> RotatingCapture:
    """Simulate one rotating-unit 3D capture.

    The encoder sweeps ``sweep_rad`` over ``n_lines`` scan lines; each line
    is ray-cast from the composed world<-base<-laser pose of ``chain`` (an
    ``ingest.frames.FrameChain``, evaluated on the CPU).
    """
    angles = np.linspace(0.0, sweep_rad, n_lines).astype(np.float32)
    Ts = chain.base_from_laser(torch.from_numpy(angles)).numpy()

    pts = np.zeros((n_lines, n_beams, 3), np.float32)
    val = np.zeros((n_lines, n_beams), bool)
    for i in range(n_lines):
        T_ws = T_world_base @ Ts[i]
        pts[i], val[i] = simulate_line_scan(
            world, T_ws, n_beams=n_beams, fov_deg=fov_deg,
            noise_std=noise_std, rng=rng)
    return RotatingCapture(line_points=pts, line_valid=val,
                           line_transforms=Ts.astype(np.float32),
                           encoder_angles=angles)


def simulate_vlp16_revolution(world: World, T_world_sensor: np.ndarray,
                              n_azimuth: int = 900,
                              max_range: float = 130.0,
                              min_range: float = 0.4,
                              noise_std: float = 0.0,
                              rng: Optional[np.random.Generator] = None,
                              device=None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """One VLP-16 revolution. Returns (points_sensor (N,3) f32, valid)."""
    dirs_s = vlp16_directions(n_azimuth)
    R, t = T_world_sensor[:3, :3], T_world_sensor[:3, 3]
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(t, dirs_w.shape)
    r = world.raycast(origins, dirs_w, max_range, device=device)
    valid = np.isfinite(r) & (r >= min_range)
    if noise_std > 0 and rng is not None:
        r = r + rng.normal(0.0, noise_std, r.shape)
    pts = dirs_s * np.where(valid, r, 0.0)[:, None]
    return pts.astype(np.float32), valid


def simulate_vlp16_range_image(world: World, T_world_sensor: np.ndarray,
                               n_azimuth: int = 1808,
                               max_range: float = 130.0,
                               noise_std: float = 0.0,
                               rng: Optional[np.random.Generator] = None,
                               device=None
                               ) -> Tuple[np.ndarray, np.ndarray]:
    """One revolution as the (azimuth, ring) range image the device emits:
    (azimuth_deg (S,), ranges_m (S, 16)), 0 = no return (the wire
    convention of a VLP-16 data packet). S = 1808 firing sequences is 600
    RPM at the 55.296 us firing period."""
    dirs_s = vlp16_directions(n_azimuth)
    R, t = T_world_sensor[:3, :3], T_world_sensor[:3, 3]
    dirs_w = dirs_s @ R.T
    origins = np.broadcast_to(t, dirs_w.shape)
    r = world.raycast(origins, dirs_w, max_range, device=device)
    if noise_std > 0 and rng is not None:
        r = r + rng.normal(0.0, noise_std, r.shape)
    r = np.where(np.isfinite(r), r, 0.0).reshape(n_azimuth, 16)
    az = np.degrees(np.linspace(0.0, 2 * np.pi, n_azimuth, endpoint=False))
    return az, r.astype(np.float64)


def synthesize_vlp16_pcap(path: str, world: World, trajectory: np.ndarray,
                          n_azimuth: int = 1808, max_range: float = 130.0,
                          noise_std: float = 0.0,
                          rng: Optional[np.random.Generator] = None,
                          device=None) -> str:
    """Render a VLP-16 capture along ``trajectory`` (one revolution a
    pose, the sensor still within it) and write it as a pcap that replays
    through velodyne.read_pcap -> VelodyneStream. Returns the path."""
    from tpu_slam_torch.ingest import velodyne as vlp

    rev_period = vlp.SEQ_PERIOD_US * 1e-6 * n_azimuth
    all_pkts = []
    for k in range(trajectory.shape[0]):
        az, r = simulate_vlp16_range_image(
            world, trajectory[k], n_azimuth=n_azimuth, max_range=max_range,
            noise_std=noise_std, rng=rng, device=device)
        all_pkts.append(vlp.encode_packets(az, r,
                                           start_time_s=k * rev_period))
    pkts = np.concatenate(all_pkts)
    n_per = all_pkts[0].shape[0]
    ts = (np.arange(pkts.shape[0], dtype=np.float64) % n_per
          * vlp.SEQS_PER_PACKET * vlp.SEQ_PERIOD_US * 1e-6)
    ts = ts + np.repeat(np.arange(len(all_pkts)) * rev_period, n_per)
    return vlp.write_pcap(path, pkts, timestamps_s=ts)


def se2_pose(x: float, y: float, yaw: float, z: float = 0.0) -> np.ndarray:
    """Planar robot pose -> 4x4 world<-base transform."""
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    T[:3, 3] = [x, y, z]
    return T


def trajectory_loop(n_poses: int, radius: float = 3.0,
                    z: float = 0.5) -> np.ndarray:
    """(N, 4, 4) circular trajectory that closes on itself (loop closure)."""
    Ts = np.zeros((n_poses, 4, 4))
    for i in range(n_poses):
        a = 2 * np.pi * i / n_poses
        Ts[i] = se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + np.pi / 2, z)
    return Ts


def dense_city(extent: float = 200.0, block_pitch: float = 24.0,
               road_halfwidth: float = 7.0, seed: int = 0) -> World:
    """A dense grid-city: ground plane + building blocks on a street grid."""
    rng = np.random.default_rng(seed)
    e = np.array
    h = extent / 2
    patches = [Patch(e([-h, -h, 0.0]), e([extent, 0, 0]), e([0, extent, 0]))]
    n_cells = int(extent // block_pitch)
    for i in range(n_cells):
        for j in range(n_cells):
            cx = -h + (i + 0.5) * block_pitch
            cy = -h + (j + 0.5) * block_pitch
            # leave the grid roads clear; buildings fill the block interior
            w = block_pitch - 2 * road_halfwidth - rng.uniform(0, 2)
            d = block_pitch - 2 * road_halfwidth - rng.uniform(0, 2)
            if w < 3 or d < 3:
                continue
            x, y = cx - w / 2, cy - d / 2
            z = rng.uniform(6, 18)
            lo = e([x, y, 0.0]); hi = e([x + w, y + d, z])
            dd = hi - lo
            patches += [
                Patch(e([lo[0], lo[1], hi[2]]), e([dd[0], 0, 0]),
                      e([0, dd[1], 0])),
                Patch(lo, e([dd[0], 0, 0]), e([0, 0, dd[2]])),
                Patch(e([lo[0], hi[1], lo[2]]), e([dd[0], 0, 0]),
                      e([0, 0, dd[2]])),
                Patch(lo, e([0, dd[1], 0]), e([0, 0, dd[2]])),
                Patch(e([hi[0], lo[1], lo[2]]), e([0, dd[1], 0]),
                      e([0, 0, dd[2]])),
            ]
    return World(patches)


def outdoor_block(n_buildings: int = 8, extent: float = 60.0,
                  seed: int = 0) -> World:
    """An outdoor city block: a ground plane and box buildings, a clear
    ring road at 12-18 m of the origin."""
    rng = np.random.default_rng(seed)
    e = np.array
    h = extent / 2
    patches = [Patch(e([-h, -h, 0.0]), e([extent, 0, 0]), e([0, extent, 0]))]
    placed = []
    tries = 0
    while len(placed) < n_buildings and tries < 200:
        tries += 1
        w, d = rng.uniform(5, 12, 2)
        x, y = rng.uniform(-h + 8, h - 8 - max(w, d), 2)
        cx, cy = x + w / 2, y + d / 2
        if math.hypot(cx, cy) < 22.0:
            continue
        if any(abs(cx - px) < (w + pw) / 2 + 4
               and abs(cy - py) < (d + pd) / 2 + 4
               for px, py, pw, pd in placed):
            continue
        placed.append((cx, cy, w, d))
        z = rng.uniform(4, 10)
        lo = e([x, y, 0.0]); hi = e([x + w, y + d, z])
        dd = hi - lo
        patches += [
            Patch(e([lo[0], lo[1], hi[2]]), e([dd[0], 0, 0]),
                  e([0, dd[1], 0])),
            Patch(lo, e([dd[0], 0, 0]), e([0, 0, dd[2]])),
            Patch(e([lo[0], hi[1], lo[2]]), e([dd[0], 0, 0]),
                  e([0, 0, dd[2]])),
            Patch(lo, e([0, dd[1], 0]), e([0, 0, dd[2]])),
            Patch(e([hi[0], lo[1], lo[2]]), e([0, dd[1], 0]),
                  e([0, 0, dd[2]])),
        ]
    return World(patches)


def ring_corridor(outer: Tuple[float, float, float] = (30.0, 22.0, 3.0),
                  inner: Tuple[float, float] = (18.0, 10.0)) -> World:
    """A rectangular ring corridor (office-building floor around a core).

    The drift workload for the SLAM backend benches: inside a straight
    corridor leg a lidar sees two parallel walls + floor + ceiling, so the
    along-corridor translation is constrained only by whatever end-wall
    geometry is in range — odometry drifts along the leg and loop closure
    on completing the lap must pull it back. Two small pillars mid-leg
    give the scene just enough texture that odometry does not fail
    outright.
    """
    ox, oy, oz = outer
    ix, iy = inner
    # sparse wall cabinets: enough texture that odometry degrades
    # gracefully (m-scale lap drift) instead of failing outright
    pillars = [
        (np.array([-ix / 4, -oy / 2 + 0.6, 0.0]),
         np.array([-ix / 4 + 0.5, -oy / 2 + 1.1, 2.2])),
        (np.array([ix / 4, oy / 2 - 1.1, 0.0]),
         np.array([ix / 4 + 0.5, oy / 2 - 0.6, 2.2])),
        (np.array([ox / 2 - 1.0, -iy / 4, 0.0]),
         np.array([ox / 2 - 0.4, -iy / 4 + 0.8, 1.4])),
        (np.array([-ox / 2 + 0.4, iy / 4, 0.0]),
         np.array([-ox / 2 + 1.0, iy / 4 + 0.8, 1.4])),
        (np.array([0.0, -iy / 2 - 0.9, 0.0]),
         np.array([0.6, -iy / 2 - 0.3, 1.8])),
        (np.array([-0.6, iy / 2 + 0.3, 0.0]),
         np.array([0.0, iy / 2 + 0.9, 1.8])),
    ]
    # shallow door frames every ~6 m along the outer walls (0.15 m deep):
    # the along-corridor fix a real office floor provides
    for x in np.arange(-ox / 2 + 4.0, ox / 2 - 3.0, 6.0):
        pillars.append((np.array([x, -oy / 2, 0.0]),
                        np.array([x + 0.25, -oy / 2 + 0.15, 2.1])))
        pillars.append((np.array([x + 1.1, oy / 2 - 0.15, 0.0]),
                        np.array([x + 1.35, oy / 2, 2.1])))
    for y in np.arange(-oy / 2 + 4.0, oy / 2 - 3.0, 6.0):
        pillars.append((np.array([-ox / 2, y, 0.0]),
                        np.array([-ox / 2 + 0.15, y + 0.25, 2.1])))
        pillars.append((np.array([ox / 2 - 0.15, y + 1.1, 0.0]),
                        np.array([ox / 2, y + 1.35, 2.1])))
    return make_room(size=outer,
                     boxes=[(np.array([-ix / 2, -iy / 2, 0.0]),
                             np.array([ix / 2, iy / 2, oz]))] + pillars)


def corridor_route(n_poses: int, step: float = 0.45,
                   half: Tuple[float, float] = (12.0, 8.0),
                   corner_r: float = 3.0, z: float = 1.2,
                   speed_var: float = 0.0) -> np.ndarray:
    """(N, 4, 4) poses along the ring-corridor centerline, arc corners.

    The rounded-rectangle centerline at x = +-half[0], y = +-half[1];
    heading follows the direction of travel (counter-clockwise, starting
    on the south leg heading east). ``speed_var`` sinusoidally modulates
    the per-scan step by +-that fraction (a platform does not move at
    perfectly constant speed; the constant-velocity prediction then
    carries honest error into observability-poor corridor stretches).
    """
    hx, hy = half
    r = corner_r
    lx, ly = 2 * (hx - r), 2 * (hy - r)     # straight leg lengths
    qa = math.pi / 2 * r                     # corner arc length
    per = 2 * lx + 2 * ly + 4 * qa
    poses = []
    s_acc = 0.0
    for k in range(n_poses):
        if speed_var > 0.0 and k > 0:
            s_acc += step * (1.0 + speed_var * math.sin(2 * math.pi * k
                                                        / 23.0))
        elif k > 0:
            s_acc += step
        s = s_acc % per
        if s < lx:                                       # south leg, east
            poses.append(se2_pose(-hx + r + s, -hy, 0.0, z=z))
            continue
        s -= lx
        if s < qa:                                       # SE corner
            th = s / r
            poses.append(se2_pose(hx - r + r * math.sin(th),
                                  -hy + r * (1 - math.cos(th)), th, z=z))
            continue
        s -= qa
        if s < ly:                                       # east leg, north
            poses.append(se2_pose(hx, -hy + r + s, math.pi / 2, z=z))
            continue
        s -= ly
        if s < qa:                                       # NE corner
            th = s / r
            poses.append(se2_pose(hx - r * (1 - math.cos(th)),
                                  hy - r + r * math.sin(th),
                                  math.pi / 2 + th, z=z))
            continue
        s -= qa
        if s < lx:                                       # north leg, west
            poses.append(se2_pose(hx - r - s, hy, math.pi, z=z))
            continue
        s -= lx
        if s < qa:                                       # NW corner
            th = s / r
            poses.append(se2_pose(-hx + r - r * math.sin(th),
                                  hy - r * (1 - math.cos(th)),
                                  math.pi + th, z=z))
            continue
        s -= qa
        if s < ly:                                       # west leg, south
            poses.append(se2_pose(-hx, hy - r - s, 1.5 * math.pi, z=z))
            continue
        s -= ly
        th = s / r                                       # SW corner
        poses.append(se2_pose(-hx + r * (1 - math.cos(th)),
                              -hy + r - r * math.sin(th),
                              1.5 * math.pi + th, z=z))
    return np.stack(poses)
