"""Full 6D SLAM: odometry + keyframes + loop closure + pose-graph backend.

Port of ``tpu_slam.pipeline.slam`` on both odometry engines: the sparse
voxel-map engine (``odometry_engine="host"``, ``pipeline.odometry``, the
default) and the dense-window engine (``"dense"``). Keyframe clouds,
normals, scan-context descriptors and the pose graph live in
fixed-capacity tensors on the engine's device; loop candidates are
verified as one batched symmetric ICP (graph.loop_closure); the pose graph
is optimized with the matrix-free GN (graph.pose_graph). After an accepted
loop the odometry is re-anchored at the optimized keyframe and its map
rebuilt from the keyframes (``reanchor_after_loop`` /
``rebuild_map_after_loop``), or left to free-run (loosely coupled).
With ``collect_loop_debug`` each loop sweep appends its proposed pairs
and their outcomes to ``loop_debug``.

``stage_seconds`` accumulates the wall time of each stage of ``step``
(odometry, keyframe store, loop verification, graph solve), each closed by
a device synchronisation so the time lands in the stage that spent it;
``sweep_seconds`` splits a loop sweep's share the same way (candidates,
verify, graph, re-anchor). While the recorder records
(``utils.tracing``), each such stage is also a span (``stage.<name>``,
``sweep.<name>``) between the same synchronisations, under the step's
span ``slam.step``, and a whole loop sweep is the span ``sweep``.

With ``compiled`` (the default) the reference's compiled programs run as
CUDA graph replays on a CUDA device and in their sync-free forms on the
CPU: the dense engine's step, the host engine's registrations and map
insert (see ``pipeline.odometry_dense`` and ``pipeline.odometry``), the
keyframe store (the reference's ``_store_kf_device``: the scan padded or
cut to P rows, its rows, the normals' covariances, the descriptor, the
node and the odometry edge, with the keyframe index k and edge slot e as
device scalars, so one capture serves every keyframe; the normals' eigh,
which reads its status back, runs after the replay), the scan-context
score of a sweep (``graph.scan_context.sc_distances``), each direction of
the loop verification's batched ICP, the graph solves (see
``registration.icp`` and ``graph.pose_graph``) and the rebuilds after an
accepted loop: the host engine's map (``_rebuild_map_program``: the
flatten, the empty map and the insert's body; its overflow flag read
after it, the full merge eager on overflow) and the dense engine's
windows (``_rebuild_grid_program``, one graph a window), each with n (and
the centre) as device inputs, so one capture serves every sweep.
``warm_up`` captures them before a stream. ``compiled=False`` runs them
all eagerly, with the same bits.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.graph.loop_closure import (propose_candidates,
                                               verify_candidates)
from tpu_slam_torch.graph.pose_graph import (PoseGraph, add_edge,
                                             captured_solve,
                                             drop_node_prefix, empty_graph,
                                             n_edges, optimize_pose_graph)
from tpu_slam_torch.graph.scan_context import (propose_sc_candidates,
                                               sc_distances, scan_context)
from tpu_slam_torch.mapping.dense_map import (centered_origin_cell,
                                              empty_grid,
                                              empty_occupancy_grid,
                                              grid_insert)
from tpu_slam_torch.mapping.voxel_map import (_insert_program,
                                              _stamp_tensor, empty_map,
                                              insert_cloud, settle_insert)
from tpu_slam_torch.pipeline.config import SLAMConfig
from tpu_slam_torch.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam_torch.pipeline.odometry import LidarOdometry, OdometryState
from tpu_slam_torch.pipeline.odometry_dense import (DenseLidarOdometry,
                                                    DenseOdomState)
from tpu_slam_torch.registration.normals import (estimate_normals,
                                                 normal_covariances,
                                                 normals_from_covariances)
from tpu_slam_torch.utils import tracing
from tpu_slam_torch.utils.capture import CapturedCall, compiled_call

STAGES = ("odometry", "keyframe", "verify", "graph")
# a loop sweep's parts: candidates and verification make the "verify"
# stage, the solve and the re-anchor the "graph" stage
SWEEP_STAGES = ("candidates", "verify", "graph", "reanchor")


@dataclasses.dataclass
class SLAMState:
    """Host-side handle onto the full SLAM state."""

    odom: Optional[Union[OdometryState, DenseOdomState]]
    graph: PoseGraph
    kf_points: torch.Tensor    # (K, P, 3) keyframe clouds (body frame)
    kf_mask: torch.Tensor      # (K, P)
    kf_intensity: torch.Tensor  # (K, P) per-point intensity (0 when absent)
    kf_normals: torch.Tensor   # (K, P, 3) per-point normals (plane verify)
    kf_desc: torch.Tensor      # (K, R, S) scan-context descriptors
    n_keyframes: int
    last_kf_pose: torch.Tensor  # (4, 4) pose of the newest keyframe
    last_kf_pose_np: Optional[np.ndarray] = None  # host mirror
    n_loop_closures: int = 0
    # poses of keyframes evicted by the fixed-lag window, in trajectory
    # order; full trajectory = archived_poses + graph.poses[:n_keyframes]
    archived_poses: List[np.ndarray] = dataclasses.field(
        default_factory=list)
    n_evictions: int = 0
    # (i, j) pairs already admitted as loop edges
    loop_pairs: set = dataclasses.field(default_factory=set)
    # (i, j) -> n_keyframes when last verified and rejected (cooldown)
    tried_pairs: dict = dataclasses.field(default_factory=dict)


def _set_row(buf: torch.Tensor, k: int, val: torch.Tensor) -> torch.Tensor:
    """``buf`` with row k replaced (out of place: earlier states keep
    their own buffers)."""
    out = buf.clone()
    out[k] = val
    return out


def _put_row(buf: torch.Tensor, k: torch.Tensor,
             val: torch.Tensor) -> torch.Tensor:
    """``buf`` with the row at ``k`` (a (1,) long tensor on its device)
    replaced, out of place."""
    return buf.clone().index_copy_(0, k, val[None])


def _keyframe_rows(scan_ds: PointCloud, P: int):
    """The scan's first P points, mask and intensity (0 without attrs),
    padded to P rows."""
    pts_in, msk_in = scan_ds.points, scan_ds.mask
    inten_in = (scan_ds.attrs[:, 0] if scan_ds.attrs is not None
                else torch.zeros_like(msk_in, dtype=torch.float32))
    n_in = pts_in.shape[0]
    if n_in >= P:
        return pts_in[:P], msk_in[:P], inten_in[:P]
    return (torch.cat([pts_in, pts_in.new_full((P - n_in, 3), PAD_COORD)]),
            torch.cat([msk_in, msk_in.new_zeros(P - n_in)]),
            torch.cat([inten_in, inten_in.new_zeros(P - n_in)]))


def _store_program(kf, g, k, e, scan_ds: PointCloud, pose, last_kf_pose, *,
                   plane_verify, use_sc, sc, odom_edge_info):
    """The keyframe store's sync-free program (the reference's
    ``_store_kf_device``). ``kf``: the (points, mask, intensity, desc)
    buffers; ``g``: the graph's (poses, edge_i, edge_j, edge_T, edge_info,
    edge_mask); ``k``, ``e``: (1,) long tensors. The edge (k-1, k) is
    written at slot e only where k > 0 (else slot e keeps its values).
    Returns the new ``kf`` and ``g``, the pose written, and the normals'
    covariances (None without ``plane_verify``)."""
    kf_points, kf_mask, kf_intensity, kf_desc = kf
    poses, ei, ej, eT, einfo, emask = g
    pts, msk, inten = _keyframe_rows(scan_ds, kf_points.shape[1])
    cov = normal_covariances(pts, msk) if plane_verify else None
    if use_sc:
        kf_desc = _put_row(kf_desc, k, scan_context(
            PointCloud(points=pts, mask=msk, attrs=inten[:, None]), sc))
    pose = pose.clone()
    has_edge = k > 0

    def edge_row(buf, val):
        keep = has_edge.reshape((1,) + (1,) * (buf.dim() - 1))
        return _put_row(buf, e, torch.where(keep, val,
                                            buf.index_select(0, e))[0])

    g = (_put_row(poses, k, pose), edge_row(ei, k - 1), edge_row(ej, k),
         edge_row(eT, se3.inverse(last_kf_pose) @ pose),
         edge_row(einfo, odom_edge_info * torch.eye(
             6, dtype=torch.float32, device=pose.device)),
         edge_row(emask, True))
    kf = (_put_row(kf_points, k, pts), _put_row(kf_mask, k, msk),
          _put_row(kf_intensity, k, inten), kf_desc)
    return kf, g, pose, cov


# the captured keyframe stores, by their inputs' signature and static args
_stores: Dict[Tuple, CapturedCall] = {}


def _count_tensor(n, device) -> torch.Tensor:
    """``n`` (an int, or a device int tensor) as a () int32 tensor on
    ``device``; an int is filled there, with no copy from the host."""
    if isinstance(n, torch.Tensor):
        return n.to(device=device, dtype=torch.int32)
    return torch.full((), n, dtype=torch.int32, device=device)


def _flat_keyframes(poses, kf_points, kf_mask, n) -> PointCloud:
    """Every keyframe cloud at its optimized pose as one (K*P,) cloud, the
    keyframes from n (an int or a device int tensor) on masked out."""
    K, P = kf_points.shape[:2]
    world = (torch.einsum("kij,kpj->kpi", poses[:, :3, :3], kf_points)
             + poses[:, None, :3, 3])
    live = kf_mask & (torch.arange(K, device=kf_mask.device)[:, None] < n)
    return PointCloud(points=world.reshape(K * P, 3),
                      mask=live.reshape(K * P))


def _rebuild_map_program(poses, kf_points, kf_mask, n, *, spec, capacity):
    """The map rebuild's sync-free program (the reference's
    ``_rebuild_map_batched``): the flatten, the empty map and the
    incremental insert's body, every point stamped n, a () int32 device
    tensor (so one capture serves every n). Returns the insert program's
    (merged map, overflow flag, stats)."""
    dev = kf_points.device
    return _insert_program(empty_map(capacity, device=dev),
                           _flat_keyframes(poses, kf_points, kf_mask, n),
                           _stamp_tensor(n, dev), spec, incremental=True)


def _rebuild_map_batched(poses, kf_points, kf_mask, n, *, spec,
                         capacity, compiled: bool = True):
    """Sparse-map rebuild from keyframes at optimized poses: one
    ``insert_cloud`` of every live keyframe point into an empty map, all
    stamped n (recency restarts at the rebuild). ``n``: an int or a device
    int tensor. With ``compiled``, ``_rebuild_map_program`` (one graph
    replay on a CUDA device), then its overflow flag read and, on
    overflow, the full merge eagerly, as ``insert_cloud`` does."""
    dev = kf_points.device
    if not compiled:
        return insert_cloud(empty_map(capacity, device=dev),
                            _flat_keyframes(poses, kf_points, kf_mask, n),
                            spec, stamp=n, compiled=False)
    n = _count_tensor(n, dev)
    program = functools.partial(_rebuild_map_program, spec=spec,
                                capacity=capacity)
    out = compiled_call(_map_rebuilds, program,
                        (poses, kf_points, kf_mask, n),
                        static=(spec, capacity))
    return settle_insert(None, *out, n)


def _rebuild_grid_program(poses, kf_points, kf_mask, n, center, *, spec,
                          dims, align):
    """The dense-window rebuild's sync-free program (the reference's
    ``_rebuild_grid_batched``): re-center the window on ``center``, then
    one grid_insert of every live keyframe point at its optimized pose."""
    c0 = centered_origin_cell(center, spec, dims, align=align)
    return grid_insert(empty_grid(dims, c0),
                       _flat_keyframes(poses, kf_points, kf_mask, n), spec)


def _rebuild_grid_batched(poses, kf_points, kf_mask, n, center, *,
                          spec, dims, align, compiled: bool = True):
    """Dense-window rebuild from keyframes at optimized poses
    (``_rebuild_grid_program``); with ``compiled`` one graph replay on a
    CUDA device for each (spec, dims, align), n and the centre its
    inputs."""
    program = functools.partial(_rebuild_grid_program, spec=spec, dims=dims,
                                align=align)
    if not compiled:
        return program(poses, kf_points, kf_mask, n, center)
    args = (poses, kf_points, kf_mask,
            _count_tensor(n, kf_points.device), center)
    return compiled_call(_grid_rebuilds, program, args,
                         static=(spec, dims, align))


# the captured rebuilds, by their inputs' signature and static args
_map_rebuilds: Dict[Tuple, CapturedCall] = {}
_grid_rebuilds: Dict[Tuple, CapturedCall] = {}


class SLAMSystem:
    """The full pipeline. Feed scans; read poses and the graph.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, config: SLAMConfig = SLAMConfig(), device=None,
                 compiled: bool = True):
        if config.odometry.scrolling_window:
            raise ValueError(
                "SLAMSystem needs a world-fixed map (keyframe clouds are "
                "re-integrated at optimized world poses after loop "
                "closures); it bounds memory with the fixed-lag keyframe "
                "window instead of the scrolling window")
        if config.odometry_engine not in ("host", "dense"):
            raise ValueError(f"odometry_engine={config.odometry_engine!r}: "
                             "'host' or 'dense'")
        self.config = config
        self.compiled = compiled
        self.odometry = (DenseLidarOdometry(config.odometry, device=device,
                                            compiled=compiled)
                         if self._dense
                         else LidarOdometry(config.odometry, device=device,
                                            compiled=compiled))
        self.device = self.odometry.device
        self.metrics = MetricsLog()
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        self.sweep_seconds: Dict[str, float] = dict.fromkeys(SWEEP_STAGES,
                                                             0.0)
        self._pending_init_pose = None
        # per-sweep loop diagnostics (proposed pairs and each one's
        # outcome), filled when collect_loop_debug is True
        self.collect_loop_debug = False
        self.loop_debug: List[dict] = []

    @property
    def _dense(self) -> bool:
        return self.config.odometry_engine == "dense"

    def _stage(self, name: str) -> "_StageTimer":
        return _StageTimer(self.device, self.stage_seconds, name,
                           f"stage.{name}")

    def _sweep_stage(self, name: str) -> "_StageTimer":
        return _StageTimer(self.device, self.sweep_seconds, name,
                           f"sweep.{name}")

    # -- state ------------------------------------------------------------

    def init_state(self, init_pose=None) -> SLAMState:
        """Empty SLAM state; the dense engine bootstraps from the first
        scan, so its odometry state is made in the first ``step``."""
        cfg = self.config
        K, P = cfg.keyframe_capacity, cfg.keyframe_cloud_capacity
        sc = cfg.loop.sc
        dev = self.device
        self._pending_init_pose = init_pose
        f32 = dict(dtype=torch.float32, device=dev)
        return SLAMState(
            odom=None if self._dense else self.odometry.init_state(init_pose),
            graph=empty_graph(K, cfg.edge_capacity, device=dev),
            kf_points=torch.full((K, P, 3), PAD_COORD, **f32),
            kf_mask=torch.zeros((K, P), dtype=torch.bool, device=dev),
            kf_intensity=torch.zeros((K, P), **f32),
            kf_normals=torch.zeros((K, P, 3), **f32),
            kf_desc=torch.zeros((K, sc.n_rings, sc.n_sectors), **f32),
            n_keyframes=0,
            last_kf_pose=torch.eye(4, **f32))

    def warm_up(self, cloud: PointCloud) -> None:
        """Capture now what a stream of clouds of ``cloud``'s shapes (its
        values are not used) would capture at its first scans and loop
        sweeps (a compiled system on a CUDA device; otherwise nothing):
        the graph solve, the scan-context score, the after-loop rebuilds
        (the map's on the host engine, the windows' on the dense engine;
        from the state's own buffers, n = 0) and, on the host engine, its
        registrations, map insert and options (``LidarOdometry.warm_up``)
        and the keyframe store. The verification's ICP graphs are
        captured at their first batch of each size."""
        if not (self.compiled and self.device.type == "cuda"):
            return
        cfg = self.config
        if cfg.graph.solver != "dense":
            captured_solve(empty_graph(cfg.keyframe_capacity,
                                       cfg.edge_capacity, device=self.device),
                           cfg.graph)
        pending = self._pending_init_pose
        state = self.init_state()
        self._pending_init_pose = pending
        if cfg.loop.use_scan_context:
            sc_distances(state.kf_desc[0], state.kf_desc)
        rebuild = cfg.reanchor_after_loop and cfg.rebuild_map_after_loop
        if self._dense:
            if rebuild:
                self._rebuild_grids(state, 0, state.last_kf_pose[:3, 3],
                                    self.odometry.factor > 1)
            return
        self.odometry.warm_up(cloud)
        counts = (insert_cloud.fallbacks, insert_cloud.incremental)
        if rebuild:
            _rebuild_map_batched(state.graph.poses, state.kf_points,
                                 state.kf_mask, 0,
                                 spec=self.odometry.map_spec,
                                 capacity=cfg.odometry.map_capacity)
        # they count the scans' inserts only
        insert_cloud.fallbacks, insert_cloud.incremental = counts
        self._store_keyframe(state, self.odometry.downsample(cloud))

    # -- keyframe policy --------------------------------------------------

    def _is_keyframe(self, state: SLAMState,
                     pose_np: Optional[np.ndarray]) -> bool:
        """Keyframe test. The dense engine's ``step`` has read the pose
        back: the test runs on the host from it and the host mirror of the
        newest keyframe pose (every path that sets a keyframe pose sets the
        mirror), with no extra read. The host engine's (``pose_np`` None)
        runs as the reference's does, on the device's log of the relative
        pose, read back in one copy."""
        if state.n_keyframes == 0:
            return True
        if pose_np is None:
            xi = se3.log(se3.inverse(state.last_kf_pose) @ state.odom.pose)
            t, r = (float(v) for v in torch.stack([
                torch.linalg.vector_norm(xi[:3]),
                torch.linalg.vector_norm(xi[3:])]).cpu())
            return (t >= self.config.keyframe_translation
                    or r >= self.config.keyframe_rotation)
        d = np.linalg.inv(state.last_kf_pose_np) @ pose_np
        t = float(np.linalg.norm(d[:3, 3]))
        cosang = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        r = float(np.arccos(cosang))
        return (t >= self.config.keyframe_translation
                or r >= self.config.keyframe_rotation)

    def _slide_window(self, state: SLAMState) -> SLAMState:
        """Fixed-lag eviction: archive and drop the oldest keyframes.

        Runs when the keyframe or edge capacity fills. Evicted keyframe
        poses go to ``state.archived_poses``; the gauge prior re-anchors the
        window at its first surviving (optimized) pose.
        """
        cfg = self.config
        n = state.n_keyframes
        m = max(1, min(n - 2, int(round(cfg.keyframe_capacity
                                        * cfg.window_evict_fraction))))
        archived = state.archived_poses + list(
            state.graph.poses[:m].cpu().numpy())

        def shifted(buf, fill):
            pad = torch.full((m,) + tuple(buf.shape[1:]), fill,
                             dtype=buf.dtype, device=buf.device)
            return torch.cat([buf[m:], pad])

        return dataclasses.replace(
            state, graph=drop_node_prefix(state.graph, m),
            kf_points=shifted(state.kf_points, PAD_COORD),
            kf_mask=shifted(state.kf_mask, False),
            kf_intensity=shifted(state.kf_intensity, 0.0),
            kf_desc=shifted(state.kf_desc, 0.0),
            kf_normals=shifted(state.kf_normals, 0.0),
            n_keyframes=n - m, archived_poses=archived,
            loop_pairs={(i - m, j - m) for i, j in state.loop_pairs
                        if i >= m and j >= m},
            tried_pairs={(i - m, j - m): v - m
                         for (i, j), v in state.tried_pairs.items()
                         if i >= m and j >= m},
            n_evictions=state.n_evictions + m)

    def _store_keyframe(self, state: SLAMState, scan_ds: PointCloud
                        ) -> SLAMState:
        """Append the downsampled scan as keyframe k (its first P rows when
        it holds more), its normals and descriptor, node k and the
        odometry edge (k-1, k) from consecutive raw odometry poses."""
        cfg = self.config
        if (state.n_keyframes >= cfg.keyframe_capacity
                or n_edges(state.graph) + 1 > cfg.edge_capacity):
            state = self._slide_window(state)
        k = state.n_keyframes
        e = n_edges(state.graph)
        if self.compiled:
            return self._store_compiled(state, scan_ds, k, e)
        P = state.kf_points.shape[1]
        pts, msk, inten = _keyframe_rows(scan_ds, P)

        kf_normals, kf_desc = state.kf_normals, state.kf_desc
        if cfg.loop.plane_verify:
            kf_normals = _set_row(kf_normals, k, estimate_normals(pts, msk))
        if cfg.loop.use_scan_context:
            kf_desc = _set_row(kf_desc, k, scan_context(
                PointCloud(points=pts, mask=msk, attrs=inten[:, None]),
                cfg.loop.sc))

        pose = state.odom.pose.clone()
        g = state.graph
        graph = dataclasses.replace(g, poses=_set_row(g.poses, k, pose),
                                    n_nodes=k + 1)
        if k > 0:
            graph = dataclasses.replace(
                graph,
                edge_i=_set_row(g.edge_i, e, k - 1),
                edge_j=_set_row(g.edge_j, e, k),
                edge_T=_set_row(g.edge_T, e,
                                se3.inverse(state.last_kf_pose) @ pose),
                edge_info=_set_row(g.edge_info, e, cfg.odom_edge_info
                                   * torch.eye(6, dtype=torch.float32,
                                               device=self.device)),
                edge_mask=_set_row(g.edge_mask, e, True))
        return dataclasses.replace(
            state, graph=graph,
            kf_points=_set_row(state.kf_points, k, pts),
            kf_mask=_set_row(state.kf_mask, k, msk),
            kf_intensity=_set_row(state.kf_intensity, k, inten),
            kf_normals=kf_normals, kf_desc=kf_desc, n_keyframes=k + 1,
            last_kf_pose=pose, last_kf_pose_np=pose.cpu().numpy())

    def _store_compiled(self, state: SLAMState, scan_ds: PointCloud, k: int,
                        e: int) -> SLAMState:
        """``_store_keyframe`` as ``_store_program``: one graph replay on
        a CUDA device (eager on the CPU), then the normals' eigh."""
        loop = self.config.loop
        g = state.graph
        dev = self.device

        def index(i):
            return torch.full((1,), i, dtype=torch.long, device=dev)

        args = ((state.kf_points, state.kf_mask, state.kf_intensity,
                 state.kf_desc),
                (g.poses, g.edge_i, g.edge_j, g.edge_T, g.edge_info,
                 g.edge_mask), index(k), index(e), scan_ds, state.odom.pose,
                state.last_kf_pose)
        static = dict(plane_verify=loop.plane_verify,
                      use_sc=loop.use_scan_context, sc=loop.sc,
                      odom_edge_info=self.config.odom_edge_info)

        def program(*a):
            return _store_program(*a, **static)

        kf, rows, pose, cov = compiled_call(_stores, program, args,
                                            static=tuple(static.items()))
        kf_normals = state.kf_normals
        if loop.plane_verify:
            kf_normals = _set_row(kf_normals, k, normals_from_covariances(
                cov, kf[1][k]))
        graph = dataclasses.replace(
            g, poses=rows[0], n_nodes=k + 1, edge_i=rows[1], edge_j=rows[2],
            edge_T=rows[3], edge_info=rows[4], edge_mask=rows[5])
        return dataclasses.replace(
            state, graph=graph, kf_points=kf[0], kf_mask=kf[1],
            kf_intensity=kf[2], kf_normals=kf_normals, kf_desc=kf[3],
            n_keyframes=k + 1, last_kf_pose=pose,
            last_kf_pose_np=pose.cpu().numpy())

    # -- loop closure -----------------------------------------------------

    def _candidates(self, state: SLAMState) -> Tuple[np.ndarray, np.ndarray]:
        """Fresh proximity and scan-context candidate pairs (host arrays)."""
        cfg = self.config
        n = state.n_keyframes
        positions = state.graph.poses[:, :3, 3].cpu().numpy()
        ci, cj = propose_candidates(positions, n, cfg.loop)
        # drop pairs already admitted as loop edges, and pairs verified and
        # rejected within the last retry_cooldown keyframes
        cool = cfg.loop.retry_cooldown * max(1, cfg.loop_every)

        def fresh(i, j):
            p = (int(i), int(j))
            if p in state.loop_pairs:
                return False
            return n - state.tried_pairs.get(p, -10**9) >= cool

        keep = np.asarray([(j - i) >= cfg.loop.min_index_gap and fresh(i, j)
                           for i, j in zip(ci, cj)], bool).reshape(-1)
        ci, cj = ci[keep], cj[keep]
        if cfg.loop.use_scan_context and n > cfg.loop.min_index_gap + 1:
            si, sj = propose_sc_candidates(
                state.kf_desc[n - 1], state.kf_desc, n - 1, n,
                cfg.loop.sc_max_distance, cfg.loop.min_index_gap,
                cfg.loop.sc_top_k, compiled=self.compiled)
            pairs = {(int(a), int(b)) for a, b in zip(ci, cj)}
            # appearance matches beyond the drift budget are place-aliases
            new = [(a, b) for a, b in zip(si, sj)
                   if (int(a), int(b)) not in pairs and fresh(a, b)
                   and np.linalg.norm(positions[int(a)] - positions[int(b)])
                   <= cfg.loop.sc_max_pose_distance]
            if new:
                fi, fj = zip(*new)
                ci = np.concatenate([ci, np.asarray(fi, np.int32)])
                cj = np.concatenate([cj, np.asarray(fj, np.int32)])
                ci, cj = (ci[:cfg.loop.max_candidates],
                          cj[:cfg.loop.max_candidates])
        return ci, cj

    def _close_loops(self, state: SLAMState) -> Tuple[SLAMState, int]:
        cfg = self.config
        n = state.n_keyframes
        with self._stage("verify"):
            with self._sweep_stage("candidates"):
                ci, cj = self._candidates(state)
            if ci.size == 0:
                if self.collect_loop_debug:
                    self.loop_debug.append({"n": n, "pairs": []})
                return state, 0
            # the batch holds the real pairs only: pairs are independent in
            # the batched solve, so the reference's padding to
            # max_candidates (there to avoid recompiles) changes nothing
            with self._sweep_stage("verify"):
                res, accept = verify_candidates(
                    state.kf_points, state.kf_mask, state.graph.poses, ci,
                    cj, cfg.loop,
                    clouds_normals=(state.kf_normals
                                    if cfg.loop.plane_verify else None),
                    compiled=self.compiled)
                accept_np = accept.cpu().numpy()
        tried = dict(state.tried_pairs)
        for a, b, ok in zip(ci, cj, accept_np):
            if not ok:
                tried[(int(a), int(b))] = n
        state = dataclasses.replace(state, tried_pairs=tried)
        if self.collect_loop_debug:
            self.loop_debug.append(self._loop_record(state, n, ci, cj, res,
                                                     accept_np))
        if not accept_np.any():
            return state, 0

        with self._stage("graph"), self._sweep_stage("graph"):
            graph = state.graph
            accepted = np.nonzero(accept_np)[0]
            # edge capacity nearly full: the next keyframe store slides the
            # window; keep only what fits now
            accepted = accepted[:cfg.edge_capacity - n_edges(graph)]
            info = cfg.loop_edge_info * torch.eye(6, dtype=torch.float32,
                                                  device=self.device)
            for k in accepted:
                graph = add_edge(graph, int(ci[k]), int(cj[k]), res.T[k],
                                 info=info)
            loop_pairs = state.loop_pairs | {(int(ci[k]), int(cj[k]))
                                             for k in accepted}
            graph, _ = optimize_pose_graph(graph, cfg.graph,
                                           compiled=self.compiled)
            state = dataclasses.replace(
                state, graph=graph, loop_pairs=loop_pairs,
                n_loop_closures=state.n_loop_closures + len(accepted))
        if cfg.reanchor_after_loop:
            with self._stage("graph"), self._sweep_stage("reanchor"):
                state = self._reanchor(state)
        return state, len(accepted)

    @staticmethod
    def _loop_record(state: SLAMState, n: int, ci, cj, res,
                     accept_np) -> dict:
        """One sweep's diagnostics: for each verified pair its matched
        fraction, error, the refined edge's deviation from the graph's
        estimate (translation and rotation norms), convergence and
        outcome."""
        poses = state.graph.poses
        ii = torch.as_tensor(np.asarray(ci, np.int64), device=poses.device)
        jj = torch.as_tensor(np.asarray(cj, np.int64), device=poses.device)
        init = se3.inverse(poses[ii]) @ poses[jj]
        dev = se3.log(se3.inverse(res.T) @ init).cpu().numpy()
        frac = res.matched_fraction.cpu().numpy()
        err = res.error.cpu().numpy()
        conv = res.converged.cpu().numpy()
        return {"n": n, "pairs": [
            {"i": int(a), "j": int(b), "frac": float(frac[k]),
             "err": float(err[k]),
             "dev_t": float(np.linalg.norm(dev[k, :3])),
             "dev_r": float(np.linalg.norm(dev[k, 3:])),
             "converged": bool(conv[k]), "accepted": bool(accept_np[k])}
            for k, (a, b) in enumerate(zip(ci, cj))]}

    def _reanchor(self, state: SLAMState) -> SLAMState:
        """Move odometry onto the optimized newest keyframe:
        pose = optimized_kf @ (old_kf^-1 @ pose), and rebuild both windows
        from the keyframes when ``rebuild_map_after_loop``.

        On the dense engine the rebuilt fine window may sit at a new
        origin, so the occupancy layer starts again empty at that origin.
        (The reference keeps the old layer, origin and evidence both, so its
        eviction then clears cells that are not the ones its evidence was
        gathered for.) The host engine's map and occupancy grid are keyed
        on the same world-fixed grid, so its occupancy grid carries
        over."""
        n = state.n_keyframes
        graph = state.graph
        new_kf = graph.poses[n - 1]
        new_pose = new_kf @ (se3.inverse(state.last_kf_pose)
                             @ state.odom.pose)
        odom = dataclasses.replace(state.odom, pose=new_pose)
        if self.config.rebuild_map_after_loop and not self._dense:
            cfg = self.config.odometry
            vmap = _rebuild_map_batched(
                graph.poses, state.kf_points, state.kf_mask, n,
                spec=self.odometry.map_spec, capacity=cfg.map_capacity,
                compiled=self.compiled)
            # the cached NDT field is stale after a rebuild
            odom = dataclasses.replace(odom, vmap=vmap, field=None)
        elif self.config.rebuild_map_after_loop:
            grid, wide = self._rebuild_grids(state, n, new_pose[:3, 3],
                                             odom.wide is not None)
            occ = odom.occ
            if occ is not None:
                occ = empty_occupancy_grid(self.odometry.dims,
                                           grid.origin_cell)
            odom = dataclasses.replace(odom, grid=grid, wide=wide, occ=occ)
        return dataclasses.replace(state, odom=odom, last_kf_pose=new_kf,
                                   last_kf_pose_np=new_kf.cpu().numpy())

    def _rebuild_grids(self, state: SLAMState, n, center, wide: bool):
        """The dense engine's fine window (and the wide one when ``wide``,
        else None) rebuilt from the first n keyframes, centred on
        ``center``."""
        o = self.odometry
        rebuild = dict(poses=state.graph.poses, kf_points=state.kf_points,
                       kf_mask=state.kf_mask, n=n, center=center,
                       dims=o.dims, compiled=self.compiled)
        grid = _rebuild_grid_batched(**rebuild, spec=o.map_spec,
                                     align=o.factor)
        return grid, (_rebuild_grid_batched(**rebuild, spec=o.coarse_spec,
                                            align=1) if wide else None)

    # -- main entry -------------------------------------------------------

    def step(self, state: SLAMState, cloud: PointCloud
             ) -> Tuple[SLAMState, ScanMetrics]:
        cfg = self.config
        with Stopwatch(self.device) as sw, tracing.span("slam.step",
                                                         step=True):
            with self._stage("odometry"):
                if not self._dense:
                    odom_state, m = self.odometry.step(state.odom, cloud)
                    pose_np = None
                elif state.odom is None:
                    odom_state = self.odometry.init_state(
                        cloud, self._pending_init_pose)
                    mm = np.zeros((5,), np.float32)
                    mm[1:4] = 1.0
                    pose_np = odom_state.pose.cpu().numpy()
                else:
                    odom_state = self.odometry.step(state.odom, cloud)
                    # one device->host read for pose and metrics together
                    fused = torch.cat([odom_state.pose.reshape(-1),
                                       odom_state.last_metrics]
                                      ).cpu().numpy()
                    pose_np = fused[:16].reshape(4, 4)
                    mm = fused[16:]
            if self._dense:
                m = ScanMetrics(scan_index=len(self.metrics.records),
                                iterations=int(mm[0]), residual=0.0,
                                matched_fraction=float(mm[1]),
                                wall_time_s=0.0)
                self.last_pose_np = pose_np
            state = dataclasses.replace(state, odom=odom_state)

            n_loops = 0
            if self._is_keyframe(state, pose_np):
                with self._stage("keyframe"):
                    state = self._store_keyframe(
                        state, self.odometry.downsample(cloud))
                m.is_keyframe = True
                if (state.n_keyframes % cfg.loop_every == 0
                        and state.n_keyframes > cfg.loop.min_index_gap):
                    with tracing.span("sweep"):
                        state, n_loops = self._close_loops(state)
        m.wall_time_s = sw.elapsed
        m.n_loop_closures = n_loops
        self.metrics.append(m)
        return state, m

    def run(self, clouds, init_pose=None) -> Tuple[np.ndarray, SLAMState]:
        state = self.init_state(init_pose)
        poses = []
        for cloud in clouds:
            state, _ = self.step(state, cloud)
            poses.append(state.odom.pose.cpu().numpy())
        return np.stack(poses), state


class _StageTimer(Stopwatch):
    """Adds a synchronised stage's wall time to ``table[name]``; while the
    recorder records (``utils.tracing``), the same stretch, between the
    same synchronisations, is its span ``span_name``."""

    def __init__(self, device, table: Dict[str, float], name: str,
                 span_name: str):
        super().__init__(device)
        self.table, self.name = table, name
        self.span = tracing.span(span_name)

    def __enter__(self):
        super().__enter__()
        self.span.__enter__()
        return self

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.span.__exit__(*exc)
        self.table[self.name] += self.elapsed
        return False
