"""Branch-free odometry on the sparse voxel map: the whole scan update
with its decisions kept on the device.

Port of ``tpu_slam.pipeline.odometry_jit``. ``LidarOdometry`` reads its
gating decisions back to the host every scan; this engine keeps them on
the device as masks:

  * accept and insert are ``torch.where`` masks, not Python ``if``s;
  * a rejected or low-quality scan inserts a zeroed aggregate (every key
    INVALID, every count 0), a no-op merge, so every scan runs the same
    operations;
  * the NDT field is rebuilt at the new pose every step;
  * pose, map, field and the metrics vector stay on the device.

The step is the reference's compiled program (one ``jax.jit`` of
``_step_impl`` with the state donated): ``_step_impl`` is its sync-free
body (``ndt_register``'s sync-free form, the iteration count cast on the
device). With ``compiled=True`` (the default) ``step`` replays it as one
CUDA graph on a CUDA device, captured at the first step for the state's
and the cloud's signature (``utils.capture``), and runs it eagerly on the
CPU. ``compiled=False`` runs the host-exit step, whose LM loops read their
exits back and whose iteration count is read once. Both give the same
bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest.deskew import deskew_cloud, vlp16_time_fractions
from tpu_slam_torch.kernels.downsample import voxel_downsample
from tpu_slam_torch.kernels.ndt_terms import ndt_terms
from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY
from tpu_slam_torch.mapping.voxel_map import (VoxelMap, empty_map,
                                              insert_scan_stats,
                                              scan_to_voxel_stats)
from tpu_slam_torch.pipeline.config import OdometryConfig
from tpu_slam_torch.registration.ndt import NDTField, ndt_field, ndt_register
from tpu_slam_torch.utils.capture import replay


@dataclasses.dataclass(frozen=True)
class JitOdomState:
    """Device-resident odometry state."""

    pose: torch.Tensor          # (4, 4)
    last_delta: torch.Tensor    # (4, 4)
    vmap: VoxelMap
    field: NDTField
    scan_index: torch.Tensor    # () int32
    last_metrics: torch.Tensor  # (4,) [iterations, frac, accepted, inserted]


class JitLidarOdometry:
    """Odometry whose step keeps its decisions on the device."""

    def __init__(self, config: OdometryConfig = OdometryConfig(),
                 device=None, compiled: bool = True):
        if config.method != "ndt":
            raise ValueError("JitLidarOdometry supports method='ndt'")
        self.device = default_device(device)
        self.compiled = compiled
        # captured steps by the signature of (state, cloud)
        self.graphs = {}
        self.config = config
        self.map_spec = config.map_spec()
        self.scan_spec = config.scan_spec()

    def init_state(self, first_cloud: PointCloud,
                   init_pose=None) -> JitOdomState:
        """Bootstrap from the first scan, placed at ``init_pose``."""
        dev = self.device
        pose = (torch.eye(4, dtype=torch.float32, device=dev)
                if init_pose is None
                else torch.as_tensor(np.asarray(init_pose),
                                     dtype=torch.float32, device=dev))
        vmap = insert_scan_stats(
            empty_map(self.config.map_capacity, device=dev),
            *scan_to_voxel_stats(first_cloud.transform(pose), self.map_spec),
            0.0)
        field = ndt_field(vmap, self.map_spec, self.config.ndt,
                          center=pose[:3, 3])
        return JitOdomState(
            pose=pose, last_delta=torch.eye(4, dtype=torch.float32,
                                            device=dev),
            vmap=vmap, field=field,
            scan_index=torch.ones((), dtype=torch.int32, device=dev),
            last_metrics=torch.zeros(4, dtype=torch.float32, device=dev))

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

    def step(self, state: JitOdomState, cloud: PointCloud) -> JitOdomState:
        """One scan; returns the next state (the old one is left intact).

        ``compiled`` on a CUDA device: the captured step; the state and the
        cloud are copied into the graph's inputs and the returned state's
        tensors are copies of its outputs.
        """
        if not self.compiled:
            return self._step_body(state, cloud, sync_free=False)
        if self.device.type != "cuda":
            return self._step_impl(state, cloud)
        return replay(self.graphs, self._step_impl, (state, cloud),
                      counters=(ndt_terms,))

    def _step_impl(self, state: JitOdomState, cloud: PointCloud
                   ) -> JitOdomState:
        """The compiled step's body: reads nothing back to the host."""
        return self._step_body(state, cloud, sync_free=True)

    def _step_body(self, state: JitOdomState, cloud: PointCloud,
                   sync_free: bool) -> JitOdomState:
        cfg = self.config
        pred = self._clamped_delta(state.last_delta)
        if cfg.deskew:
            cloud = deskew_cloud(cloud, vlp16_time_fractions(cloud.points),
                                 T_start=se3.inverse(pred),
                                 T_end=torch.eye(4, dtype=torch.float32,
                                                 device=self.device))
        scan = voxel_downsample(cloud, self.scan_spec,
                                capacity=cfg.scan_capacity)
        init_T = state.pose @ pred
        res = ndt_register(scan, state.field, self.map_spec, init_T=init_T,
                           params=cfg.ndt, sync_free=sync_free)

        accepted = res.matched_fraction >= cfg.min_accept_fraction
        # one polar-Newton step against f32 composition drift
        T = se3.orthonormalize(torch.where(accepted, res.T, init_T))
        delta = se3.inverse(state.pose) @ T

        # insertion without a branch: a scan that does not qualify merges
        # a zeroed aggregate, which changes nothing
        do_insert = accepted & (res.matched_fraction
                                >= cfg.min_insert_fraction)
        keys, cnt, ssum, souter = scan_to_voxel_stats(cloud.transform(T),
                                                      self.map_spec)
        keys = torch.where(do_insert, keys, INVALID_KEY).to(torch.int32)
        cnt = torch.where(do_insert, cnt, 0.0)
        vmap = insert_scan_stats(state.vmap, keys, cnt, ssum, souter,
                                 state.scan_index.to(torch.float32))
        # the field is rebuilt every step, the window centred at the new
        # pose
        field = ndt_field(vmap, self.map_spec, cfg.ndt, center=T[:3, 3])
        iterations = (res.iterations.to(torch.float32) if sync_free else
                      torch.full((), float(res.iterations),
                                 device=self.device))
        metrics = torch.stack([
            iterations, res.matched_fraction, accepted.to(torch.float32),
            do_insert.to(torch.float32)])
        return JitOdomState(pose=T, last_delta=delta, vmap=vmap, field=field,
                            scan_index=state.scan_index + 1,
                            last_metrics=metrics)
