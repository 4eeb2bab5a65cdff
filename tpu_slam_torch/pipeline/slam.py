"""Full 6D SLAM: odometry + keyframes + loop closure + pose-graph backend.

Port of ``tpu_slam.pipeline.slam`` for the dense-window odometry engine.
Keyframe clouds, normals, scan-context descriptors and the pose graph live
in fixed-capacity tensors on the engine's device; loop candidates are
verified as one batched symmetric ICP (graph.loop_closure); the pose graph
is optimized with the matrix-free GN (graph.pose_graph). After an accepted
loop the odometry is re-anchored at the optimized keyframe and its windows
rebuilt from the keyframes (``reanchor_after_loop`` /
``rebuild_map_after_loop``), or left to free-run (loosely coupled).

``stage_seconds`` accumulates the wall time of each stage of ``step``
(odometry, keyframe store, loop verification, graph solve), each closed by
a device synchronisation so the time lands in the stage that spent it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.core import se3
from tpu_slam_torch.core.pointcloud import PAD_COORD, PointCloud
from tpu_slam_torch.graph.loop_closure import (propose_candidates,
                                               verify_candidates)
from tpu_slam_torch.graph.pose_graph import (PoseGraph, add_edge,
                                             drop_node_prefix, empty_graph,
                                             n_edges, optimize_pose_graph)
from tpu_slam_torch.graph.scan_context import (propose_sc_candidates,
                                               scan_context)
from tpu_slam_torch.mapping.dense_map import (centered_origin_cell,
                                              empty_grid, grid_insert)
from tpu_slam_torch.pipeline.config import SLAMConfig
from tpu_slam_torch.pipeline.metrics import MetricsLog, ScanMetrics, Stopwatch
from tpu_slam_torch.pipeline.odometry_dense import (DenseLidarOdometry,
                                                    DenseOdomState)
from tpu_slam_torch.registration.normals import estimate_normals

STAGES = ("odometry", "keyframe", "verify", "graph")


@dataclasses.dataclass
class SLAMState:
    """Host-side handle onto the full SLAM state."""

    odom: Optional[DenseOdomState]
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


def _rebuild_grid_batched(poses, kf_points, kf_mask, n: int, center, *,
                          spec, dims, align):
    """Dense-window rebuild from keyframes at optimized poses: re-center
    the window on ``center``, then one grid_insert of every live keyframe
    point at its optimized pose."""
    K, P = kf_points.shape[:2]
    world = (torch.einsum("kij,kpj->kpi", poses[:, :3, :3], kf_points)
             + poses[:, None, :3, 3])
    live = kf_mask & (torch.arange(K, device=kf_mask.device)[:, None] < n)
    flat = PointCloud(points=world.reshape(K * P, 3),
                      mask=live.reshape(K * P))
    c0 = centered_origin_cell(center, spec, dims, align=align)
    return grid_insert(empty_grid(dims, c0), flat, spec)


class SLAMSystem:
    """The full pipeline. Feed scans; read poses and the graph.

    Runs on ``device`` (CUDA unless the caller asks for the CPU).
    """

    def __init__(self, config: SLAMConfig = SLAMConfig(), device=None):
        if config.odometry.scrolling_window:
            raise ValueError(
                "SLAMSystem needs a world-fixed map (keyframe clouds are "
                "re-integrated at optimized world poses after loop "
                "closures); it bounds memory with the fixed-lag keyframe "
                "window instead of the scrolling window")
        if config.odometry_engine != "dense":
            raise NotImplementedError(
                f"odometry_engine={config.odometry_engine!r}: only the "
                "dense engine is ported; pass odometry_engine='dense'")
        self.config = config
        self.odometry = DenseLidarOdometry(config.odometry, device=device)
        self.device = self.odometry.device
        self.metrics = MetricsLog()
        self.stage_seconds: Dict[str, float] = dict.fromkeys(STAGES, 0.0)
        self._pending_init_pose = None

    def _stage(self, name: str) -> "_StageTimer":
        return _StageTimer(self, name)

    # -- state ------------------------------------------------------------

    def init_state(self, init_pose=None) -> SLAMState:
        """Empty SLAM state; the dense engine bootstraps from the first
        scan, so the odometry state is made in the first ``step``."""
        cfg = self.config
        K, P = cfg.keyframe_capacity, cfg.keyframe_cloud_capacity
        sc = cfg.loop.sc
        dev = self.device
        self._pending_init_pose = init_pose
        f32 = dict(dtype=torch.float32, device=dev)
        return SLAMState(
            odom=None,
            graph=empty_graph(K, cfg.edge_capacity, device=dev),
            kf_points=torch.full((K, P, 3), PAD_COORD, **f32),
            kf_mask=torch.zeros((K, P), dtype=torch.bool, device=dev),
            kf_intensity=torch.zeros((K, P), **f32),
            kf_normals=torch.zeros((K, P, 3), **f32),
            kf_desc=torch.zeros((K, sc.n_rings, sc.n_sectors), **f32),
            n_keyframes=0,
            last_kf_pose=torch.eye(4, **f32))

    # -- keyframe policy --------------------------------------------------

    def _is_keyframe(self, state: SLAMState, pose_np: np.ndarray) -> bool:
        """Keyframe test on the host, from the pose ``step`` already read
        back and the host mirror of the newest keyframe pose (every path
        that sets a keyframe pose sets the mirror): no extra sync."""
        if state.n_keyframes == 0:
            return True
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
        P = state.kf_points.shape[1]
        pts_in, msk_in = scan_ds.points, scan_ds.mask
        inten_in = (scan_ds.attrs[:, 0] if scan_ds.attrs is not None
                    else torch.zeros_like(msk_in, dtype=torch.float32))
        n_in = pts_in.shape[0]
        if n_in >= P:
            pts, msk, inten = pts_in[:P], msk_in[:P], inten_in[:P]
        else:
            pts = torch.cat([pts_in, pts_in.new_full((P - n_in, 3),
                                                     PAD_COORD)])
            msk = torch.cat([msk_in, msk_in.new_zeros(P - n_in)])
            inten = torch.cat([inten_in, inten_in.new_zeros(P - n_in)])

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
                cfg.loop.sc_top_k)
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
            ci, cj = self._candidates(state)
            if ci.size == 0:
                return state, 0
            # the batch holds the real pairs only: pairs are independent in
            # the batched solve, so the reference's padding to
            # max_candidates (there to avoid recompiles) changes nothing
            res, accept = verify_candidates(
                state.kf_points, state.kf_mask, state.graph.poses, ci, cj,
                cfg.loop,
                clouds_normals=(state.kf_normals if cfg.loop.plane_verify
                                else None))
            accept_np = accept.cpu().numpy()
        tried = dict(state.tried_pairs)
        for a, b, ok in zip(ci, cj, accept_np):
            if not ok:
                tried[(int(a), int(b))] = n
        state = dataclasses.replace(state, tried_pairs=tried)
        if not accept_np.any():
            return state, 0

        with self._stage("graph"):
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
            graph, _ = optimize_pose_graph(graph, cfg.graph)
            state = dataclasses.replace(
                state, graph=graph, loop_pairs=loop_pairs,
                n_loop_closures=state.n_loop_closures + len(accepted))
            if cfg.reanchor_after_loop:
                state = self._reanchor(state)
        return state, len(accepted)

    def _reanchor(self, state: SLAMState) -> SLAMState:
        """Move odometry onto the optimized newest keyframe:
        pose = optimized_kf @ (old_kf^-1 @ pose), and rebuild both windows
        from the keyframes when ``rebuild_map_after_loop``."""
        n = state.n_keyframes
        graph = state.graph
        new_kf = graph.poses[n - 1]
        new_pose = new_kf @ (se3.inverse(state.last_kf_pose)
                             @ state.odom.pose)
        odom = dataclasses.replace(state.odom, pose=new_pose)
        if self.config.rebuild_map_after_loop:
            o = self.odometry
            rebuild = dict(poses=graph.poses, kf_points=state.kf_points,
                           kf_mask=state.kf_mask, n=n,
                           center=new_pose[:3, 3], dims=o.dims)
            grid = _rebuild_grid_batched(**rebuild, spec=o.map_spec,
                                         align=o.factor)
            wide = odom.wide
            if wide is not None:
                wide = _rebuild_grid_batched(**rebuild, spec=o.coarse_spec,
                                             align=1)
            odom = dataclasses.replace(odom, grid=grid, wide=wide)
        return dataclasses.replace(state, odom=odom, last_kf_pose=new_kf,
                                   last_kf_pose_np=new_kf.cpu().numpy())

    # -- main entry -------------------------------------------------------

    def step(self, state: SLAMState, cloud: PointCloud
             ) -> Tuple[SLAMState, ScanMetrics]:
        cfg = self.config
        with Stopwatch(self.device) as sw:
            with self._stage("odometry"):
                if state.odom is None:
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
            m = ScanMetrics(scan_index=len(self.metrics.records),
                            iterations=int(mm[0]), residual=0.0,
                            matched_fraction=float(mm[1]), wall_time_s=0.0)
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
    """Adds a synchronised stage's wall time to ``system.stage_seconds``."""

    def __init__(self, system: SLAMSystem, name: str):
        super().__init__(system.device)
        self.system, self.name = system, name

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.system.stage_seconds[self.name] += self.elapsed
        return False
