"""Scan-to-map LiDAR odometry on the sparse voxel map (the host engine).

Port of ``tpu_slam.pipeline.odometry``. The map, pose and fields live on
the engine's device; the loop and its decisions live on the host. A scan:

  1. optional deskew with the predicted motion, then voxel-downsample;
  2. predict the pose (constant velocity, clamped);
  3. register the scan against the map: NDT on the cached field (a
     coarse stage on the coarsened map first when ``pyramid_factor`` > 1),
     or ICP against the voxel means (point-to-plane with neighbourhood
     normals for ``icp_plane``);
  4. read every gating decision back in ONE device-to-host copy: a
     collapsed match fraction rejects the registration and coasts on the
     prediction; an accepted one inserts the raw cloud into the map;
  5. optional occupancy maintenance (free-space eviction; one more read
     of the evicted count), and on the scrolling window a rebase when the
     sensor leaves the window's core.

The NDT field is cached and rebuilt only on the scan after the map
changed (an insert, an eviction or a rebase); ``field_builds`` counts the
builds. While the recorder records (``utils.tracing``) a tracked scan's
parts are spans: ``host.prep`` (deskew and downsample), ``host.field``
(a field build; the host counter ``host_field_builds`` counts them),
``host.register`` (the registrations and the gating read) and
``host.insert`` (the map insert and its overflow read); the first two
close on a device synchronisation, the last two end on their reads.
The reference's compiled programs on the step each run, with
``compiled=True`` (the default), as one CUDA graph replay on a CUDA
device and in their sync-free form on the CPU: each NDT registration (the
coarse one, then the fine one; ``registration.ndt.compiled_register``),
the ICP flavours' solve (``registration.icp.icp``), the map insert
(``mapping.voxel_map.insert_cloud``, whose overflow flag is read after
it), and the options' programs: the pyramid's ``coarsen_map`` at each
field build, the occupancy maintenance (``_occupancy_program``: the
scan's transform, ``ray_evidence``, ``occupancy_update`` and the eviction
as one graph; the evicted count read after it) and the deskew
(``_deskew_program``: the time fractions, the clamped prediction and
``deskew_cloud``). ``warm_up`` captures them before a stream.
``compiled=False`` runs their host-exit forms, whose loops read their
exits back. Both give the same bits; the gating read of step 4 stays, as
it does in the reference's host engine. ``scan_max_range`` and
``insert_downsampled`` belong to the dense engine: this engine registers
the whole downsampled scan and inserts the raw cloud, as the reference
does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest.deskew import deskew_cloud, vlp16_time_fractions
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.mapping.occupancy import (empty_occupancy,
                                              occupancy_maintain,
                                              shift_occupancy_cells)
from tpu_slam_torch.mapping.voxel_map import (VoxelMap, coarse_spec_of,
                                              coarsen_map, empty_map,
                                              insert_cloud, voxel_means,
                                              voxel_normals_neighborhood)
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam_torch.registration.icp import icp
from tpu_slam_torch.registration.ndt import compiled_register, ndt_field
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import CapturedCall, compiled_call


@dataclasses.dataclass
class OdometryState:
    """Host-side handle onto the engine's device-resident state."""

    pose: torch.Tensor          # (4, 4) world <- body
    last_delta: torch.Tensor    # (4, 4) previous relative motion
    vmap: VoxelMap
    scan_index: int = 0
    # cached (fine, coarse-or-None) NDT fields; None = rebuild next scan
    field: object = None
    # log-odds occupancy grid (config.use_occupancy only)
    occ: object = None
    # scrolling window: world = local + map_offset, a float64 host array of
    # exact leaf multiples; None when the map grid is world-fixed
    map_offset: Optional[np.ndarray] = None


def _clamp_delta(delta: torch.Tensor, max_t: float, max_r: float
                 ) -> torch.Tensor:
    """Clamp the constant-velocity extrapolation: one misconverged
    registration must not throw the next prediction out of the basin."""
    xi = se3.log(delta)
    t_n = torch.linalg.vector_norm(xi[:3])
    r_n = torch.linalg.vector_norm(xi[3:])
    scale = torch.minimum(
        torch.clamp(max_t / torch.clamp(t_n, min=1e-9), max=1.0),
        torch.clamp(max_r / torch.clamp(r_n, min=1e-9), max=1.0))
    return se3.exp(xi * scale)


def _deskew_program(cloud: PointCloud, last_delta: torch.Tensor, *,
                    max_t: float, max_r: float) -> torch.Tensor:
    """The host engine's deskew (the reference's ``deskew_cloud`` with its
    VLP-16 time fractions, against the clamped prediction's inverse): the
    cloud's points in the sweep-end frame."""
    pred = _clamp_delta(last_delta, max_t, max_r)
    return deskew_cloud(
        cloud, vlp16_time_fractions(cloud.points), T_start=se3.inverse(pred),
        T_end=torch.eye(4, dtype=torch.float32,
                        device=cloud.points.device)).points


def _occupancy_program(occ, vmap, T, scan: PointCloud, *, spec, n_steps,
                       max_range, evict_below):
    """One scan's occupancy maintenance (the reference's
    ``occupancy_maintain``: ``ray_evidence``, ``occupancy_update``, the
    eviction) from the sensor at T, the scan taken there: (grid, map,
    evicted count)."""
    return occupancy_maintain(occ, vmap, T[:3, 3], scan.transform(T), spec,
                              n_steps=n_steps, max_range=max_range,
                              evict_below=evict_below)


# the captured option programs, by their inputs' signature and static args
_coarsens: Dict[Tuple, CapturedCall] = {}
_maintains: Dict[Tuple, CapturedCall] = {}
_deskews: Dict[Tuple, CapturedCall] = {}


class LidarOdometry:
    """Frame-to-map odometry engine on the sparse voxel map."""

    def __init__(self, config: OdometryConfig = OdometryConfig(),
                 device=None, compiled: bool = True):
        self.device = default_device(device)
        self.compiled = compiled
        self.config = config
        self.map_spec = config.map_spec()
        self.scan_spec = config.scan_spec()
        self.metrics = MetricsLog()
        self.field_builds = 0

    def init_state(self, init_pose=None) -> OdometryState:
        dev = self.device
        cfg = self.config
        pose = (torch.eye(4, dtype=torch.float32, device=dev)
                if init_pose is None
                else torch.as_tensor(np.asarray(init_pose),
                                     dtype=torch.float32, device=dev))
        occ = None
        if cfg.use_occupancy:
            occ = empty_occupancy(cfg.occupancy_capacity, device=dev)
        offset = None
        if cfg.scrolling_window:
            # the window starts centred on the initial pose
            t0 = pose[:3, 3].cpu().numpy()
            offset = np.round(t0 / cfg.map_leaf) * cfg.map_leaf
        return OdometryState(
            pose=pose, last_delta=torch.eye(4, dtype=torch.float32,
                                            device=dev),
            vmap=empty_map(cfg.map_capacity, device=dev), occ=occ,
            map_offset=offset)

    def _to_local(self, T: torch.Tensor, offset) -> torch.Tensor:
        """World -> map-local pose (scrolling window; identity when off)."""
        if offset is None:
            return T
        out = T.clone()
        out[:3, 3] -= torch.as_tensor(offset, dtype=torch.float32,
                                      device=T.device)
        return out

    def _to_world(self, T: torch.Tensor, offset) -> torch.Tensor:
        if offset is None:
            return T
        out = T.clone()
        out[:3, 3] += torch.as_tensor(offset, dtype=torch.float32,
                                      device=T.device)
        return out

    def _maybe_rebase(self, vmap, occ, field, offset, t_local: np.ndarray):
        """Re-centre the window when the sensor leaves its core (host)."""
        cfg = self.config
        half = 0.5 * self.map_spec.extent
        if np.max(np.abs(t_local)) <= half * (1.0 - 2.0 * cfg.rebase_fraction):
            return vmap, occ, field, offset
        from tpu_slam_torch.mapping.voxel_map import shift_map_cells
        shift = np.round(t_local / cfg.map_leaf).astype(np.int32)
        shift_t = torch.as_tensor(shift, device=self.device)
        vmap = shift_map_cells(vmap, self.map_spec, shift_t)
        if occ is not None:
            occ = shift_occupancy_cells(occ, self.map_spec, shift_t)
        offset = offset + shift.astype(np.float64) * cfg.map_leaf
        return vmap, occ, None, offset       # the field cache is stale

    def _maintain_occupancy(self, occ, vmap, T, scan):
        """Free-space update and seen-through voxel eviction
        (``_occupancy_program``)."""
        cfg = self.config
        static = dict(spec=self.map_spec, n_steps=cfg.occupancy_steps,
                      max_range=cfg.occupancy_max_range,
                      evict_below=cfg.occupancy_evict_below)
        return self._program(_maintains, functools.partial(
            _occupancy_program, **static),
            (occ, vmap, T, PointCloud(scan.points, scan.mask)),
            tuple(static.items()))

    def _deskew(self, cloud: PointCloud, last_delta: torch.Tensor
                ) -> PointCloud:
        """``cloud`` undistorted with the predicted sweep motion
        (``_deskew_program``)."""
        cfg = self.config
        static = dict(max_t=cfg.max_pred_translation,
                      max_r=cfg.max_pred_rotation)
        pts = self._program(_deskews, functools.partial(
            _deskew_program, **static),
            (PointCloud(cloud.points, cloud.mask), last_delta),
            tuple(static.items()))
        return dataclasses.replace(cloud, points=pts)

    def _coarsen(self, vmap: VoxelMap) -> VoxelMap:
        """The map re-aggregated at the pyramid's coarse leaf."""
        static = dict(spec=self.map_spec, factor=self.config.pyramid_factor)
        return self._program(_coarsens,
                             functools.partial(coarsen_map, **static),
                             (vmap,), tuple(static.items()))

    def _program(self, cache, fn, args, static):
        """``fn(*args)``: a graph replay from ``cache`` when compiled (on a
        CUDA device; eager on the CPU), else eager."""
        if not self.compiled:
            return fn(*args)
        return compiled_call(cache, fn, args, static=static)

    def downsample(self, cloud: PointCloud) -> PointCloud:
        return voxel_downsample(cloud, self.scan_spec,
                                capacity=self.config.scan_capacity)

    def _clamped_delta(self, delta: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        return _clamp_delta(delta, cfg.max_pred_translation,
                            cfg.max_pred_rotation)

    def _coarse_params(self):
        cfg = self.config
        # the coarse window covers pyramid_factor x the fine one's metric
        # extent; capped at half the fine dims (multiples of 8, >= 16)
        wdims = cfg.ndt.window_dims
        if wdims is not None:
            wdims = tuple(max(16, (d // 2 + 7) // 8 * 8) for d in wdims)
        return dataclasses.replace(
            cfg.ndt, max_iterations=max(10, cfg.ndt.max_iterations // 2),
            window_dims=wdims,
            max_corr_dist=cfg.ndt.max_corr_dist * cfg.pyramid_factor)

    def _build_fields(self, vmap: VoxelMap, center=None):
        """(fine field, coarse field or None) for the NDT method."""
        cfg = self.config
        self.field_builds += 1
        fine = ndt_field(vmap, self.map_spec, cfg.ndt, center=center)
        coarse = None
        if cfg.pyramid_factor > 1:
            cspec = coarse_spec_of(self.map_spec, cfg.pyramid_factor)
            cmap = self._coarsen(vmap)
            coarse = ndt_field(cmap, cspec, self._coarse_params(),
                               center=center)
        return fine, coarse

    def _register(self, scan: PointCloud, init_T: torch.Tensor,
                  vmap: VoxelMap, field=None):
        """(T, iterations, residual, matched fraction) of one scan."""
        cfg = self.config
        if cfg.method == "ndt":
            if field is None:
                field = self._build_fields(vmap, center=init_T[:3, 3])
            fine, coarse = field
            if coarse is not None:
                cspec = coarse_spec_of(self.map_spec, cfg.pyramid_factor)
                init_T = compiled_register(
                    scan, coarse, cspec, init_T=init_T,
                    params=self._coarse_params(), compiled=self.compiled).T
            res = compiled_register(scan, fine, self.map_spec, init_T=init_T,
                                    params=cfg.ndt, compiled=self.compiled)
            return res.T, res.iterations, res.score, res.matched_fraction
        # ICP flavours register against the map's voxel means
        means = voxel_means(vmap, self.map_spec)
        tgt = PointCloud(points=means, mask=vmap.occupied_mask())
        normals = None
        params = cfg.icp
        if cfg.method == "icp_plane":
            # neighbourhood normals; only planar voxels are plane targets
            normals, n_valid = voxel_normals_neighborhood(vmap,
                                                          self.map_spec)
            tgt = PointCloud(points=means,
                             mask=vmap.occupied_mask() & n_valid).sanitize()
            params = dataclasses.replace(cfg.icp, point_to_plane=True)
        res = icp(scan, tgt, init_T=init_T, params=params,
                  target_normals=normals, compiled=self.compiled)
        return res.T, res.iterations, res.error, res.matched_fraction

    def warm_up(self, cloud: Optional[PointCloud] = None) -> None:
        """Capture the engine's graphs for this config's shapes now (a
        compiled engine on a CUDA device; otherwise nothing): the NDT
        registrations and, with a pyramid, ``coarsen_map``, by one
        registration of an empty scan against the empty map's fields, as
        the first tracked scan would run it; the occupancy maintenance of
        such a scan; with ``cloud`` (a cloud of the stream's shapes; its
        values are not used), the map insert and the deskew of such a
        cloud."""
        if not (self.compiled and self.device.type == "cuda"):
            return
        cfg = self.config
        state = self.init_state()
        n = cfg.scan_capacity
        empty = self.downsample(PointCloud(
            points=torch.zeros((n, 3), dtype=torch.float32,
                               device=self.device),
            mask=torch.zeros(n, dtype=torch.bool, device=self.device)))
        pose = self._to_local(state.pose, state.map_offset)
        if cfg.method == "ndt":
            builds = self.field_builds
            self._register(empty, pose, state.vmap)
            self.field_builds = builds      # counts the scans' builds only
        if cfg.use_occupancy:
            self._maintain_occupancy(state.occ, state.vmap, pose, empty)
        if cloud is not None:
            counts = (insert_cloud.fallbacks, insert_cloud.incremental)
            insert_cloud(state.vmap, cloud.transform(state.pose),
                         self.map_spec)
            # they count the scans' inserts only
            insert_cloud.fallbacks, insert_cloud.incremental = counts
            if cfg.deskew:
                self._deskew(cloud, state.last_delta)

    def step(self, state: OdometryState, cloud: PointCloud
             ) -> Tuple[OdometryState, ScanMetrics]:
        """Process one scan (body-frame points)."""
        cfg = self.config
        with Stopwatch() as sw:
            with tracing.span("host.prep", device=self.device):
                if cfg.deskew and state.scan_index > 0:
                    cloud = self._deskew(cloud, state.last_delta)
                scan = self.downsample(cloud)
            if state.scan_index == 0:
                new_state, fields = self._bootstrap(state, cloud, scan)
            else:
                new_state, fields = self._track(state, cloud, scan)
        m = ScanMetrics(scan_index=state.scan_index, wall_time_s=sw.elapsed,
                        **fields)
        self.metrics.append(m)
        return new_state, m

    def _bootstrap(self, state: OdometryState, cloud: PointCloud,
                   scan: PointCloud):
        """The first scan: the RAW cloud at the initial pose feeds the map
        (downsampled scans leave too few points a voxel for its
        Gaussian)."""
        T0_loc = self._to_local(state.pose, state.map_offset)
        vmap = insert_cloud(state.vmap, cloud.transform(T0_loc),
                            self.map_spec, stamp=0.0, compiled=self.compiled)
        occ = state.occ
        if self.config.use_occupancy:
            occ, vmap, _ = self._maintain_occupancy(occ, vmap, T0_loc, scan)
        return (OdometryState(pose=state.pose, last_delta=state.last_delta,
                              vmap=vmap, scan_index=1, occ=occ,
                              map_offset=state.map_offset),
                dict(iterations=0, residual=0.0, matched_fraction=1.0))

    def _track(self, state: OdometryState, cloud: PointCloud,
               scan: PointCloud):
        """Register, gate, insert, maintain occupancy and rebase: the next
        state and the scan's metrics."""
        cfg = self.config
        f32 = torch.float32
        offset = state.map_offset
        pose_loc = self._to_local(state.pose, offset)
        # (re)build the cached NDT field(s) only when the map changed
        field = state.field
        if cfg.method == "ndt" and field is None:
            with tracing.span("host.field", device=self.device):
                field = self._build_fields(state.vmap, center=pose_loc[:3, 3])
            tracing.count("host_field_builds", 1)
        init_T = (pose_loc @ self._clamped_delta(state.last_delta)
                  if cfg.use_constant_velocity else pose_loc)
        with tracing.span("host.register"):
            T, iters, resid, frac = self._register(scan, init_T, state.vmap,
                                                   field)

            # ONE device-to-host read carries every gating decision; T and
            # init_T are map-local, the relative delta frame-invariant
            delta_reg = se3.inverse(pose_loc) @ T
            xi_reg = se3.log(delta_reg)
            stats = torch.cat([
                torch.stack([frac.to(f32),
                             torch.as_tensor(iters, dtype=f32,
                                             device=self.device),
                             resid.to(f32),
                             torch.linalg.vector_norm(xi_reg[:3]),
                             torch.linalg.vector_norm(xi_reg[3:])]),
                T[:3, 3], init_T[:3, 3]]).cpu().numpy()
        frac_h, iters_h, resid_h, dt_h, dr_h = (float(v) for v in stats[:5])

        # divergence guard: coast on the prediction when the match
        # fraction collapsed
        rejected = frac_h < cfg.min_accept_fraction
        if rejected:
            T = init_T
            delta = se3.inverse(pose_loc) @ T
            t_local = stats[8:11]
        else:
            delta = delta_reg
            t_local = stats[5:8]

        vmap = state.vmap
        if (state.scan_index % cfg.insert_every == 0 and not rejected
                and frac_h >= cfg.min_insert_fraction):
            with tracing.span("host.insert"):
                vmap = insert_cloud(vmap, cloud.transform(T), self.map_spec,
                                    stamp=float(state.scan_index),
                                    compiled=self.compiled)
            field = None                # the map changed

        occ = state.occ
        if cfg.use_occupancy and not rejected:
            occ, vmap, n_evict = self._maintain_occupancy(occ, vmap, T, scan)
            if int(n_evict) > 0:        # one more read, feature-gated
                field = None

        if offset is not None:
            vmap, occ, field, offset = self._maybe_rebase(
                vmap, occ, field, offset, t_local)

        # back to world, and one polar-Newton step against f32 drift
        T = se3.orthonormalize(self._to_world(T, state.map_offset))
        return (OdometryState(pose=T, last_delta=delta, vmap=vmap,
                              scan_index=state.scan_index + 1, field=field,
                              occ=occ, map_offset=offset),
                dict(iterations=int(iters_h), residual=resid_h,
                     matched_fraction=frac_h, translation_delta=dt_h,
                     rotation_delta=dr_h))

    def run(self, clouds, init_pose=None) -> Tuple[np.ndarray, MetricsLog]:
        """Process an iterable of clouds; returns (poses (N, 4, 4), log)."""
        state = self.init_state(init_pose)
        poses = []
        for cloud in clouds:
            state, _ = self.step(state, cloud)
            poses.append(state.pose)
        return torch.stack(poses).cpu().numpy(), self.metrics
