"""Dense-window odometry: scroll, coarse + fine NDT register, gate, insert.

Port of ``tpu_slam.pipeline.odometry_dense``. The odometry-rate map is a
scrolling dense moment window (mapping.dense_map) at the map leaf, plus a
wide window of the same cell dims at ``pyramid_factor`` x the leaf whose
field drives the coarse stage (yaw search + GNC) and the fine solve's far
tier. Every LM evaluation runs the NDT terms kernel (csrc/ndt_terms.cu).
Two options follow the reference: ``deskew`` undistorts each scan with
the predicted motion before it is registered, and ``use_occupancy`` keeps a
log-odds layer aligned with the fine window whose free-space evidence
clears the moments of cells a moving object has left.

The state lives on the engine's device; ``run`` reads pose and metrics
back every ``sync_every`` scans.

The step is the reference's compiled program: ``_step_impl`` is its
sync-free body (the scroll shift, the LM loops' exits and the iteration
count stay on the device). With ``compiled=True`` (the default, as the
reference always jits) ``step`` replays it as one CUDA graph on a CUDA
device, captured at the first step for the state's and the cloud's
shapes and strides (``utils.capture``), and runs it eagerly on the CPU.
``compiled=False`` runs the host-exit step, whose LM loops read their
exit conditions back (the counterpart of ``jax.disable_jit``); both give
the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest.deskew import deskew_cloud, vlp16_time_fractions
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.ndt_terms import ndt_terms
from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
from tpu_slam_torch.mapping.dense_map import (DenseMomentGrid,
                                              centered_origin_cell,
                                              empty_grid,
                                              empty_occupancy_grid,
                                              grid_insert, grid_ndt_field,
                                              grid_occupancy_update,
                                              grid_recenter_shift,
                                              grid_scroll)
from tpu_slam_torch.mapping.voxel_map import coarse_spec_of
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam_torch.registration.ndt import lm_trips, ndt_register
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import replay


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
    # log-odds layer aligned with the fine window (rows (G, 1)); None
    # unless config.use_occupancy
    occ: Optional[DenseMomentGrid] = None


class DenseLidarOdometry:
    """Dense-window odometry engine on one device (CUDA by default)."""

    def __init__(self, config: OdometryConfig = OdometryConfig(),
                 device=None, compiled: bool = True):
        if config.method != "ndt":
            raise ValueError("DenseLidarOdometry supports method='ndt'")
        if config.ndt.window_dims is None:
            raise ValueError("config.ndt.window_dims must be set (the dense "
                             "window shape)")
        self.device = default_device(device)
        self.compiled = compiled
        # captured steps by the signature of (state, cloud)
        self.graphs = {}
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
        # cells the occupancy layer has cleared since init_state (int64 on
        # the device; a diagnostic, not part of the state)
        self.n_evicted = (torch.zeros((), dtype=torch.int64,
                                      device=self.device)
                          if config.use_occupancy else None)

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
        occ = None
        if self.config.use_occupancy:
            occ = empty_occupancy_grid(self.dims, c0)
            self.n_evicted = torch.zeros((), dtype=torch.int64, device=dev)
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
            wide=wide, occ=occ)

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
        """One scan: returns the next state (the old one is left intact).

        ``compiled`` on a CUDA device: the captured step (see the module
        docstring); the state and the cloud are copied into the graph's
        inputs and the returned state's tensors are copies of its outputs.
        """
        with tracing.span("odometry.step", step=True):
            if not self.compiled:
                nxt, n_ev = self._step_body(state, cloud, sync_free=False)
            elif self.device.type != "cuda":
                nxt, n_ev = self._step_impl(state, cloud)
            else:
                nxt, n_ev = replay(self.graphs, self._step_impl,
                                   (state, cloud), counters=(ndt_terms,))
            if self.device.type == "cuda":
                tracing.keep_marks(self.device)
        if n_ev is not None:
            self.n_evicted = self.n_evicted + n_ev
        return nxt

    def _step_impl(self, state: DenseOdomState, cloud: PointCloud
                   ) -> Tuple[DenseOdomState, Optional[torch.Tensor]]:
        """The compiled step's body: reads nothing back to the host.
        Returns (next state, cells evicted or None)."""
        return self._step_body(state, cloud, sync_free=True)

    def _step_body(self, state: DenseOdomState, cloud: PointCloud,
                   sync_free: bool):
        """The step in five stages, each opened by its mark
        (``utils.tracing.mark``; ``ndt_register`` marks its rasters and
        solves): prep (prediction, deskew, both downsamples, range gate),
        map (the windows' scrolls and inserts), field (both NDT fields),
        raster and solve (the registrations)."""
        with tracing.stage_marks(self.device):
            return self._stages(state, cloud, sync_free)

    def _stages(self, state: DenseOdomState, cloud: PointCloud,
                sync_free: bool):
        cfg = self.config
        tracing.mark("prep")
        pred = self._clamped_delta(state.last_delta)
        if cfg.deskew:
            # the scan moved by pred during its sweep: carry every point to
            # the sweep-end frame
            cloud = deskew_cloud(cloud, vlp16_time_fractions(cloud.points),
                                 T_start=se3.inverse(pred),
                                 T_end=torch.eye(4, dtype=torch.float32,
                                                 device=self.device))
        scan = self.downsample(cloud)
        if self.factor > 1:
            cscan = voxel_downsample(cloud, self.coarse_scan_spec,
                                     capacity=self.coarse_scan_capacity)
        if cfg.scan_max_range > 0:
            rng2 = torch.sum(scan.points[:, :2] ** 2, dim=1)
            scan = PointCloud(
                points=scan.points,
                mask=scan.mask & (rng2 < cfg.scan_max_range ** 2),
                attrs=scan.attrs).sanitize()
        init_T = state.pose @ pred

        # scroll the windows when the predicted pose leaves their core
        tracing.mark("map")
        shift = grid_recenter_shift(state.grid, init_T[:3, 3], self.map_spec,
                                    align=self.factor,
                                    deadband_fraction=cfg.rebase_fraction)
        grid = grid_scroll(state.grid, shift)
        occ = state.occ
        if occ is not None:
            occ = grid_scroll(occ, shift)   # stays aligned with the window
        wide = state.wide
        if self.factor > 1:
            wshift = grid_recenter_shift(wide, init_T[:3, 3],
                                         self.coarse_spec, align=1,
                                         deadband_fraction=cfg.rebase_fraction)
            wide = grid_scroll(wide, wshift)

        tracing.mark("field")
        if self.factor > 1:
            cfield = grid_ndt_field(wide, self.coarse_spec,
                                    min_voxel_count=cfg.ndt.min_voxel_count,
                                    evec_floor_ratio=cfg.ndt.evec_floor_ratio)
        field = grid_ndt_field(grid, self.map_spec,
                               min_voxel_count=cfg.ndt.min_voxel_count,
                               evec_floor_ratio=cfg.ndt.evec_floor_ratio)

        # coarse capture on the WIDE window's field, then the fine polish
        coarse_frac = torch.ones((), dtype=torch.float32, device=self.device)
        T1 = init_T
        far_kw = {}
        iters_used, trips = 0, lm_trips(cfg.ndt)
        if self.factor > 1:
            rc = ndt_register(cscan, cfield, self.coarse_spec, init_T=init_T,
                              params=self.coarse_params, sync_free=sync_free)
            T1, coarse_frac = rc.T, rc.matched_fraction
            iters_used, trips = rc.iterations, trips + lm_trips(
                self.coarse_params)
            # far tier: scan points beyond the fine window register against
            # the wide field
            far_kw = dict(far_field=cfield, far_spec=self.coarse_spec)
        res = ndt_register(scan, field, self.map_spec, init_T=T1,
                           params=cfg.ndt, sync_free=sync_free, **far_kw)
        iters_used = iters_used + res.iterations
        # LM iterations whose loop condition held against the trips run
        # (the host-exit form runs only those)
        tracing.device_count("ndt_lm_iters_used", iters_used, self.device)
        tracing.device_count("ndt_lm_iters_run",
                             trips if sync_free else iters_used, self.device)

        accepted = res.matched_fraction >= cfg.min_accept_fraction
        # one polar-Newton step per scan keeps the rotation orthonormal
        T = se3.orthonormalize(torch.where(accepted, res.T, init_T))
        delta = se3.inverse(state.pose) @ T

        tracing.mark("map")
        do_insert = accepted & (res.matched_fraction
                                >= cfg.min_insert_fraction)
        weight = do_insert.to(torch.float32)
        world_scan = (scan if cfg.insert_downsampled else cloud).transform(T)
        grid = grid_insert(grid, world_scan, self.map_spec, weight=weight)
        if wide is not None:
            wide = grid_insert(wide, world_scan, self.coarse_spec,
                               weight=weight)
        n_ev = None
        if occ is not None:
            grid, occ, n_ev = grid_occupancy_update(
                grid, occ, T[:3, 3], world_scan, self.map_spec,
                n_steps=cfg.occupancy_steps,
                max_range=cfg.occupancy_max_range,
                evict_below=cfg.occupancy_evict_below, weight=weight)

        iterations = (res.iterations.to(torch.float32) if sync_free else
                      torch.full((), float(res.iterations),
                                 device=self.device))
        metrics = torch.stack([
            iterations, res.matched_fraction, accepted.to(torch.float32),
            weight, coarse_frac])
        return DenseOdomState(pose=T, last_delta=delta, grid=grid,
                              scan_index=state.scan_index + 1,
                              last_metrics=metrics, wide=wide,
                              occ=occ), n_ev

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
