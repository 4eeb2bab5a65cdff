"""Dense-window odometry: scroll, coarse + fine NDT register, gate, insert.

Port of ``tpu_slam.pipeline.odometry_dense``. The odometry-rate map is a
scrolling dense moment window (mapping.dense_map) at the map leaf, plus a
wide window of the same cell dims at ``pyramid_factor`` x the leaf whose
field drives the coarse stage (yaw search + GNC) and the fine solve's far
tier. Every LM evaluation runs the NDT terms kernel (csrc/ndt_terms.cu).

The state lives on the engine's device; ``run`` reads pose and metrics
back every ``sync_every`` scans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping.dense_map import (DenseMomentGrid,
                                              centered_origin_cell,
                                              empty_grid, grid_insert,
                                              grid_ndt_field,
                                              grid_recenter_shift,
                                              grid_scroll)
from tpu_slam_torch.mapping.voxel_map import coarse_spec_of
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam_torch.registration.ndt import ndt_register


@dataclasses.dataclass(frozen=True)
class DenseOdomState:
    """Odometry state, all tensors on the engine's device."""

    pose: torch.Tensor          # (4, 4) world<-body
    last_delta: torch.Tensor    # (4, 4)
    grid: DenseMomentGrid
    scan_index: torch.Tensor    # () int32
    last_metrics: torch.Tensor  # (5,) [iterations, frac, accepted,
                                #       inserted, coarse_frac]
    # wide coarse moment window (same dims at the coarse leaf); None when
    # pyramid_factor <= 1
    wide: Optional[DenseMomentGrid] = None


class DenseLidarOdometry:
    """Dense-window odometry engine on one device (CUDA by default)."""

    def __init__(self, config: OdometryConfig = OdometryConfig(),
                 device=None):
        if config.method != "ndt":
            raise ValueError("DenseLidarOdometry supports method='ndt'")
        if config.ndt.window_dims is None:
            raise ValueError("config.ndt.window_dims must be set (the dense "
                             "window shape)")
        if config.use_occupancy:
            raise NotImplementedError("use_occupancy (dense occupancy "
                                      "eviction) is not ported yet")
        if config.deskew:
            raise NotImplementedError("deskew is not ported yet")
        self.device = default_device(device)
        self.config = config
        self.map_spec = config.map_spec()
        self.scan_spec = config.scan_spec()
        self.dims = tuple(config.ndt.window_dims)
        self.factor = max(1, config.pyramid_factor)
        if self.factor > 1:
            self.coarse_spec = coarse_spec_of(self.map_spec, self.factor)
            self.coarse_params = self._coarse_params()
            # coarse-stage scan: downsampled at half the coarse leaf
            self.coarse_scan_spec = VoxelGridSpec.centered(
                leaf=config.map_leaf * self.factor / 2,
                half_extent=config.map_half_extent)
            self.coarse_scan_capacity = max(2048, config.scan_capacity // 4)
        self.metrics = MetricsLog()

    def _coarse_params(self):
        cfg = self.config
        f = self.factor
        return dataclasses.replace(
            cfg.ndt,
            max_iterations=max(6, cfg.ndt.max_iterations // 2),
            coarse_iterations=max(2, cfg.ndt.coarse_iterations),
            max_corr_dist=cfg.ndt.max_corr_dist * f,
            raster_q=min(8, cfg.ndt.raster_q * 2),
            yaw_candidates=max(5, cfg.ndt.yaw_candidates),
            yaw_span=max(0.3, cfg.ndt.yaw_span),
            window_dims=tuple(d // f for d in self.dims))

    # -- lifecycle --------------------------------------------------------

    def init_state(self, first_cloud: PointCloud,
                   init_pose=None) -> DenseOdomState:
        dev = self.device
        pose = (torch.eye(4, dtype=torch.float32, device=dev)
                if init_pose is None
                else torch.as_tensor(init_pose, dtype=torch.float32,
                                     device=dev))
        c0 = centered_origin_cell(pose[:3, 3], self.map_spec, self.dims,
                                  align=self.factor)
        world_first = first_cloud.transform(pose)
        grid = grid_insert(empty_grid(self.dims, c0), world_first,
                           self.map_spec)
        wide = None
        if self.factor > 1:
            c0w = centered_origin_cell(pose[:3, 3], self.coarse_spec,
                                       self.dims, align=1)
            wide = grid_insert(empty_grid(self.dims, c0w), world_first,
                               self.coarse_spec)
        return DenseOdomState(
            pose=pose, last_delta=torch.eye(4, dtype=torch.float32,
                                            device=dev),
            grid=grid, scan_index=torch.ones((), dtype=torch.int32,
                                             device=dev),
            last_metrics=torch.zeros(5, dtype=torch.float32, device=dev),
            wide=wide)

    def downsample(self, cloud: PointCloud) -> PointCloud:
        return voxel_downsample(cloud, self.scan_spec,
                                capacity=self.config.scan_capacity)

    def _clamped_delta(self, delta: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        xi = se3.log(delta)
        t_n = torch.linalg.vector_norm(xi[:3])
        r_n = torch.linalg.vector_norm(xi[3:])
        scale = torch.minimum(
            torch.clamp(cfg.max_pred_translation
                        / torch.clamp(t_n, min=1e-9), max=1.0),
            torch.clamp(cfg.max_pred_rotation
                        / torch.clamp(r_n, min=1e-9), max=1.0))
        return se3.exp(xi * scale)

    def step(self, state: DenseOdomState, cloud: PointCloud
             ) -> DenseOdomState:
        """One scan: returns the next state (the old one is left intact)."""
        cfg = self.config
        pred = self._clamped_delta(state.last_delta)
        scan = self.downsample(cloud)
        if cfg.scan_max_range > 0:
            rng2 = torch.sum(scan.points[:, :2] ** 2, dim=1)
            scan = PointCloud(
                points=scan.points,
                mask=scan.mask & (rng2 < cfg.scan_max_range ** 2),
                attrs=scan.attrs).sanitize()
        init_T = state.pose @ pred

        # scroll the window when the predicted pose leaves its core
        shift = grid_recenter_shift(state.grid, init_T[:3, 3], self.map_spec,
                                    align=self.factor,
                                    deadband_fraction=cfg.rebase_fraction)
        grid = grid_scroll(state.grid, shift)

        # coarse capture on the WIDE window's field, then the fine polish
        coarse_frac = torch.ones((), dtype=torch.float32, device=self.device)
        T1 = init_T
        wide = state.wide
        far_kw = {}
        if self.factor > 1:
            wshift = grid_recenter_shift(wide, init_T[:3, 3],
                                         self.coarse_spec, align=1,
                                         deadband_fraction=cfg.rebase_fraction)
            wide = grid_scroll(wide, wshift)
            cfield = grid_ndt_field(wide, self.coarse_spec,
                                    min_voxel_count=cfg.ndt.min_voxel_count,
                                    evec_floor_ratio=cfg.ndt.evec_floor_ratio)
            cscan = voxel_downsample(cloud, self.coarse_scan_spec,
                                     capacity=self.coarse_scan_capacity)
            rc = ndt_register(cscan, cfield, self.coarse_spec, init_T=init_T,
                              params=self.coarse_params)
            T1, coarse_frac = rc.T, rc.matched_fraction
            # far tier: scan points beyond the fine window register against
            # the wide field
            far_kw = dict(far_field=cfield, far_spec=self.coarse_spec)
        field = grid_ndt_field(grid, self.map_spec,
                               min_voxel_count=cfg.ndt.min_voxel_count,
                               evec_floor_ratio=cfg.ndt.evec_floor_ratio)
        res = ndt_register(scan, field, self.map_spec, init_T=T1,
                           params=cfg.ndt, **far_kw)

        accepted = res.matched_fraction >= cfg.min_accept_fraction
        # one polar-Newton step per scan keeps the rotation orthonormal
        T = se3.orthonormalize(torch.where(accepted, res.T, init_T))
        delta = se3.inverse(state.pose) @ T

        do_insert = accepted & (res.matched_fraction
                                >= cfg.min_insert_fraction)
        weight = do_insert.to(torch.float32)
        world_scan = (scan if cfg.insert_downsampled else cloud).transform(T)
        grid = grid_insert(grid, world_scan, self.map_spec, weight=weight)
        if wide is not None:
            wide = grid_insert(wide, world_scan, self.coarse_spec,
                               weight=weight)

        metrics = torch.stack([
            torch.full((), float(res.iterations), device=self.device),
            res.matched_fraction, accepted.to(torch.float32), weight,
            coarse_frac])
        return DenseOdomState(pose=T, last_delta=delta, grid=grid,
                              scan_index=state.scan_index + 1,
                              last_metrics=metrics, wide=wide)

    # -- host conveniences ------------------------------------------------

    def run(self, clouds, init_pose=None,
            sync_every: int = 1) -> Tuple[np.ndarray, MetricsLog]:
        """Process an iterable of clouds; returns (poses (N,4,4), log).

        ``sync_every`` = 1 reads pose and metrics every scan; larger values
        read metrics every k scans, 0 never (poses are collected on the
        device and read at the end).
        """
        it = iter(clouds)
        state = self.init_state(next(it), init_pose)
        poses = [state.pose]
        for k, cloud in enumerate(it, start=1):
            sync = bool(sync_every) and k % sync_every == 0
            with Stopwatch(self.device if sync else None) as sw:
                state = self.step(state, cloud)
            poses.append(state.pose)
            if sync:
                m = state.last_metrics.cpu().numpy()
                self.metrics.append(ScanMetrics(
                    scan_index=k, iterations=int(m[0]), residual=0.0,
                    matched_fraction=float(m[1]), wall_time_s=sw.elapsed))
        return torch.stack(poses).cpu().numpy(), self.metrics
