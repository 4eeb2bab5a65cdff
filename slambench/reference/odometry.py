"""Plain re-computation of the dense-window odometry step.

The step of ``DenseLidarOdometry`` as the frozen copies in this package
compute it, eagerly and with host-exit LM loops: the clamped
constant-velocity prediction, the downsample and range gate, the scroll of
the fine and the wide moment windows, the coarse NDT on the wide field
with its yaw search, the fine NDT with the far tier, the accept and
insert gate, and the insert into both windows.

``DenseOdometryReference`` keeps its own windows. ``follow`` advances them
with a pose and an insert flag given from outside (the poses the program
returned), registering the scan itself only where asked; ``forward``
advances them with its own registration. Both work every window out again
from the raw scans.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch

from slambench.reference import se3
from slambench.reference.dense_map import (centered_origin_cell, empty_grid,
                                           grid_insert, grid_ndt_field,
                                           grid_recenter_shift, grid_scroll)
from slambench.reference.downsample import voxel_downsample
from slambench.reference.ndt import NDTParams, ndt_register
from slambench.reference.pointcloud import PointCloud
from slambench.reference.voxel_hash import VoxelGridSpec


def ndt_params(values: Dict) -> NDTParams:
    kw = dict(values)
    if kw.get("window_dims") is not None:
        kw["window_dims"] = tuple(kw["window_dims"])
    return NDTParams(**kw)


@dataclasses.dataclass
class StepResult:
    T: torch.Tensor          # (4, 4) the pose the step arrives at
    accepted: bool
    inserted: bool


class DenseOdometryReference:
    """The dense-window odometry of one configuration (``odometry``: the
    configuration file's ``odometry`` object)."""

    def __init__(self, odometry: Dict, device):
        self.cfg = odometry
        self.device = torch.device(device)
        self.ndt = ndt_params(odometry["ndt"])
        self.map_spec = VoxelGridSpec.centered(
            leaf=odometry["map_leaf"], half_extent=odometry["map_half_extent"])
        self.scan_spec = VoxelGridSpec.centered(
            leaf=odometry["downsample_leaf"],
            half_extent=odometry["map_half_extent"])
        self.dims = tuple(self.ndt.window_dims)
        self.factor = max(1, odometry["pyramid_factor"])
        if self.factor > 1:
            s = int(math.log2(self.factor))
            self.coarse_spec = VoxelGridSpec(
                leaf=self.map_spec.leaf * self.factor,
                origin=self.map_spec.origin,
                dim_bits=self.map_spec.dim_bits - s)
            p = self.ndt
            self.coarse_params = dataclasses.replace(
                p, max_iterations=max(6, p.max_iterations // 2),
                coarse_iterations=max(2, p.coarse_iterations),
                max_corr_dist=p.max_corr_dist * self.factor,
                raster_q=min(8, p.raster_q * 2),
                yaw_candidates=max(5, p.yaw_candidates),
                yaw_span=max(0.3, p.yaw_span),
                window_dims=tuple(d // self.factor for d in self.dims))
            self.coarse_scan_spec = VoxelGridSpec.centered(
                leaf=odometry["map_leaf"] * self.factor / 2,
                half_extent=odometry["map_half_extent"])
            self.coarse_scan_capacity = max(2048,
                                            odometry["scan_capacity"] // 4)
        self.pose = None
        self.last_delta = None
        self.grid = None
        self.wide = None

    # -- the pieces of a step -----------------------------------------

    def start(self, cloud: PointCloud, pose: torch.Tensor) -> None:
        """The first scan inserted whole at ``pose`` into fresh windows."""
        pose = pose.to(torch.float32)
        c0 = centered_origin_cell(pose[:3, 3], self.map_spec, self.dims,
                                  align=self.factor)
        world = cloud.transform(pose)
        self.grid = grid_insert(empty_grid(self.dims, c0), world,
                                self.map_spec)
        if self.factor > 1:
            c0w = centered_origin_cell(pose[:3, 3], self.coarse_spec,
                                       self.dims, align=1)
            self.wide = grid_insert(empty_grid(self.dims, c0w), world,
                                    self.coarse_spec)
        self.pose = pose
        self.last_delta = torch.eye(4, dtype=torch.float32,
                                    device=self.device)

    def downsample(self, cloud: PointCloud) -> PointCloud:
        scan = voxel_downsample(cloud, self.scan_spec,
                                capacity=self.cfg["scan_capacity"])
        rmax = self.cfg["scan_max_range"]
        if rmax > 0:
            rng2 = torch.sum(scan.points[:, :2] ** 2, dim=1)
            scan = PointCloud(points=scan.points,
                              mask=scan.mask & (rng2 < rmax ** 2),
                              attrs=scan.attrs).sanitize()
        return scan

    def _prediction(self) -> torch.Tensor:
        xi = se3.log(self.last_delta)
        t_n = torch.linalg.vector_norm(xi[:3])
        r_n = torch.linalg.vector_norm(xi[3:])
        scale = torch.minimum(
            torch.clamp(self.cfg["max_pred_translation"]
                        / torch.clamp(t_n, min=1e-9), max=1.0),
            torch.clamp(self.cfg["max_pred_rotation"]
                        / torch.clamp(r_n, min=1e-9), max=1.0))
        return self.pose @ se3.exp(xi * scale)

    def _scroll(self, init_T: torch.Tensor) -> None:
        frac = self.cfg["rebase_fraction"]
        self.grid = grid_scroll(self.grid, grid_recenter_shift(
            self.grid, init_T[:3, 3], self.map_spec, align=self.factor,
            deadband_fraction=frac))
        if self.wide is not None:
            self.wide = grid_scroll(self.wide, grid_recenter_shift(
                self.wide, init_T[:3, 3], self.coarse_spec, align=1,
                deadband_fraction=frac))

    def _register(self, cloud: PointCloud, scan: PointCloud,
                  init_T: torch.Tensor) -> StepResult:
        ndt = self.ndt
        T1, far = init_T, {}
        if self.wide is not None:
            cfield = grid_ndt_field(self.wide, self.coarse_spec,
                                    min_voxel_count=ndt.min_voxel_count,
                                    evec_floor_ratio=ndt.evec_floor_ratio)
            cscan = voxel_downsample(cloud, self.coarse_scan_spec,
                                     capacity=self.coarse_scan_capacity)
            T1 = ndt_register(cscan, cfield, self.coarse_spec, init_T=init_T,
                              params=self.coarse_params).T
            far = dict(far_field=cfield, far_spec=self.coarse_spec)
        field = grid_ndt_field(self.grid, self.map_spec,
                               min_voxel_count=ndt.min_voxel_count,
                               evec_floor_ratio=ndt.evec_floor_ratio)
        res = ndt_register(scan, field, self.map_spec, init_T=T1, params=ndt,
                           **far)
        frac = float(res.matched_fraction)
        accepted = frac >= self.cfg["min_accept_fraction"]
        T = se3.orthonormalize(res.T if accepted else init_T)
        return StepResult(T=T, accepted=accepted,
                          inserted=accepted
                          and frac >= self.cfg["min_insert_fraction"])

    def _insert(self, cloud: PointCloud, scan: PointCloud, T: torch.Tensor,
                inserted: bool) -> None:
        w = torch.full((), float(inserted), dtype=torch.float32,
                       device=self.device)
        world = (scan if self.cfg["insert_downsampled"] else cloud
                 ).transform(T)
        self.grid = grid_insert(self.grid, world, self.map_spec, weight=w)
        if self.wide is not None:
            self.wide = grid_insert(self.wide, world, self.coarse_spec,
                                    weight=w)
        self.last_delta = se3.inverse(self.pose) @ T
        self.pose = T

    # -- whole steps ------------------------------------------------------

    def follow(self, cloud: PointCloud, T: torch.Tensor, inserted: bool,
               register: bool = False) -> Optional[StepResult]:
        """One step at the given pose and insert flag. With ``register``
        the scan is registered first, from the same prediction and
        windows, and that result returned (it does not steer the step)."""
        init_T = self._prediction()
        self._scroll(init_T)
        scan = self.downsample(cloud)
        mine = self._register(cloud, scan, init_T) if register else None
        self._insert(cloud, scan, T.to(torch.float32), inserted)
        return mine

    def forward(self, cloud: PointCloud) -> StepResult:
        """One step on the reference's own registration."""
        init_T = self._prediction()
        self._scroll(init_T)
        scan = self.downsample(cloud)
        res = self._register(cloud, scan, init_T)
        self._insert(cloud, scan, res.T, res.inserted)
        return res


def pose_gap(A: torch.Tensor, B: torch.Tensor) -> Tuple[float, float]:
    """(translation gap in m, rotation gap in rad) between two poses; the
    rotation gap is the chordal one, |R_A - R_B|_F / sqrt(2), which is the
    angle between them while it is small and needs no acos near 1."""
    A, B = A.double(), B.double()
    dt = float(torch.linalg.vector_norm(A[:3, 3] - B[:3, 3]))
    dr = float(torch.linalg.matrix_norm(A[:3, :3] - B[:3, :3])) / math.sqrt(2)
    return dt, dr
