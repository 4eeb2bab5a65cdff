"""Carry odometry/SLAM state and configuration across engines as arrays.

The system has no weights; what two engines must share to continue from
the same point is their state: ``DenseOdomState`` (pose, last delta, both
moment windows, scan index, last metrics) and, for SLAM, the pose graph,
the keyframe buffers, the counters and the loop bookkeeping. These helpers
convert both to and from dicts of numpy arrays — the form any engine's
state takes after ``np.asarray`` — and build the port's ``OdometryConfig``
and ``SLAMConfig`` from ``dataclasses.asdict`` of configurations with the
same fields. The checkpoint (pipeline.checkpoint) stores the same dict.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from tpu_slam_torch.graph.loop_closure import LoopClosureParams
from tpu_slam_torch.graph.pose_graph import GraphSolveParams, PoseGraph
from tpu_slam_torch.graph.scan_context import ScanContextParams
from tpu_slam_torch.mapping.dense_map import DenseMomentGrid
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.pipeline.odometry_dense import DenseOdomState
from tpu_slam_torch.registration.icp import ICPParams
from tpu_slam_torch.registration.ndt import NDTParams

STATE_KEYS = ("pose", "last_delta", "grid_rows", "grid_origin_cell",
              "wide_rows", "wide_origin_cell", "scan_index", "last_metrics")

# NDTParams fields of the reference that select TPU gather/layout tiers;
# the port has one kernel path and ignores them
_TPU_TIER_FIELDS = ("dense_lookup_max_bits", "pack_budget_mb",
                    "pack_any_backend", "window_bits", "terms_impl")


def state_from_numpy(d: Dict[str, np.ndarray], dims: Tuple[int, int, int],
                     device) -> DenseOdomState:
    """DenseOdomState on ``device`` from a dict of arrays (STATE_KEYS;
    the two ``wide_*`` entries may be absent or None)."""
    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    dims = tuple(dims)
    wide = None
    if d.get("wide_rows") is not None:
        wide = DenseMomentGrid(rows=t("wide_rows", torch.float32),
                               origin_cell=t("wide_origin_cell", torch.int32),
                               dims=dims)
    return DenseOdomState(
        pose=t("pose", torch.float32), last_delta=t("last_delta",
                                                    torch.float32),
        grid=DenseMomentGrid(rows=t("grid_rows", torch.float32),
                             origin_cell=t("grid_origin_cell", torch.int32),
                             dims=dims),
        scan_index=t("scan_index", torch.int32),
        last_metrics=t("last_metrics", torch.float32), wide=wide)


def state_to_numpy(state: DenseOdomState) -> Dict[str, np.ndarray]:
    """The state's tensors as host arrays under STATE_KEYS."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()

    wide = state.wide
    return {"pose": a(state.pose), "last_delta": a(state.last_delta),
            "grid_rows": a(state.grid.rows),
            "grid_origin_cell": a(state.grid.origin_cell),
            "wide_rows": a(wide.rows) if wide is not None else None,
            "wide_origin_cell": (a(wide.origin_cell) if wide is not None
                                 else None),
            "scan_index": a(state.scan_index),
            "last_metrics": a(state.last_metrics)}


def config_from_dict(d: dict) -> OdometryConfig:
    """OdometryConfig from ``dataclasses.asdict`` of an odometry config.

    Unknown fields raise (TypeError from the dataclass), except the NDT
    fields that only select the reference's TPU tiers.
    """
    d = dict(d)
    ndt = {k: v for k, v in dict(d.pop("ndt")).items()
           if k not in _TPU_TIER_FIELDS}
    if ndt.get("window_dims") is not None:
        ndt["window_dims"] = tuple(ndt["window_dims"])
    icp = dict(d.pop("icp"))
    return OdometryConfig(ndt=NDTParams(**ndt), icp=ICPParams(**icp), **d)


def slam_config_from_dict(d: dict) -> SLAMConfig:
    """SLAMConfig from ``dataclasses.asdict`` of a SLAM config, nested
    odometry, loop (ICP, scan context) and graph parameters included."""
    d = dict(d)
    loop = dict(d.pop("loop"))
    loop = LoopClosureParams(icp=ICPParams(**loop.pop("icp")),
                             sc=ScanContextParams(**loop.pop("sc")), **loop)
    return SLAMConfig(odometry=config_from_dict(d.pop("odometry")),
                      loop=loop, graph=GraphSolveParams(**d.pop("graph")),
                      **d)


def slam_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A SLAMState as host arrays: odometry state under ``odom_<key>``
    (absent before the first scan, and the wide window's entries when there
    is none), the graph under ``graph_<field>``, the keyframe buffers,
    counters, archived poses and the loop bookkeeping (``loop_pairs``
    (L, 2) and ``tried_pairs`` (T, 3) rows (i, j, n), sorted)."""
    d = {}
    if state.odom is not None:
        d.update({"odom_" + k: v for k, v in state_to_numpy(state.odom).items()
                  if v is not None})
    g = state.graph

    def a(x):
        return x.detach().cpu().numpy()

    d.update({
        "graph_poses": a(g.poses), "graph_n_nodes": np.int64(g.n_nodes),
        "graph_edge_i": a(g.edge_i), "graph_edge_j": a(g.edge_j),
        "graph_edge_T": a(g.edge_T), "graph_edge_info": a(g.edge_info),
        "graph_edge_mask": a(g.edge_mask),
        "kf_points": a(state.kf_points), "kf_mask": a(state.kf_mask),
        "kf_intensity": a(state.kf_intensity),
        "kf_normals": a(state.kf_normals), "kf_desc": a(state.kf_desc),
        "n_keyframes": np.int64(state.n_keyframes),
        "last_kf_pose": a(state.last_kf_pose),
        "n_loop_closures": np.int64(state.n_loop_closures),
        "n_evictions": np.int64(state.n_evictions),
        "archived_poses": (np.stack(state.archived_poses).astype(np.float32)
                           if state.archived_poses
                           else np.zeros((0, 4, 4), np.float32)),
        "loop_pairs": np.asarray(sorted(state.loop_pairs),
                                 np.int64).reshape(-1, 2),
        "tried_pairs": np.asarray(
            [(i, j, v) for (i, j), v in sorted(state.tried_pairs.items())],
            np.int64).reshape(-1, 3),
    })
    return d


def slam_state_from_numpy(d: Dict[str, np.ndarray],
                          dims: Optional[Tuple[int, int, int]], device):
    """SLAMState on ``device`` from the dict of ``slam_state_to_numpy``;
    ``dims`` is the dense window shape (unused when there is no odometry
    state yet)."""
    from tpu_slam_torch.pipeline.slam import SLAMState

    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    odom = None
    if "odom_pose" in d:
        odom = state_from_numpy({k[5:]: v for k, v in d.items()
                                 if k.startswith("odom_")}, dims, device)
    graph = PoseGraph(
        poses=t("graph_poses", torch.float32),
        n_nodes=int(d["graph_n_nodes"]),
        edge_i=t("graph_edge_i", torch.long),
        edge_j=t("graph_edge_j", torch.long),
        edge_T=t("graph_edge_T", torch.float32),
        edge_info=t("graph_edge_info", torch.float32),
        edge_mask=t("graph_edge_mask", torch.bool))
    last_kf = np.array(d["last_kf_pose"], np.float32)
    return SLAMState(
        odom=odom, graph=graph,
        kf_points=t("kf_points", torch.float32),
        kf_mask=t("kf_mask", torch.bool),
        kf_intensity=t("kf_intensity", torch.float32),
        kf_normals=t("kf_normals", torch.float32),
        kf_desc=t("kf_desc", torch.float32),
        n_keyframes=int(d["n_keyframes"]),
        last_kf_pose=torch.as_tensor(last_kf, device=device),
        # the host mirror the keyframe test reads; restoring it keeps a
        # resumed run on the same (host) keyframe test as an unbroken one
        last_kf_pose_np=last_kf if int(d["n_keyframes"]) > 0 else None,
        n_loop_closures=int(d["n_loop_closures"]),
        archived_poses=list(np.array(d["archived_poses"], np.float32)),
        n_evictions=int(d["n_evictions"]),
        loop_pairs={(int(i), int(j)) for i, j in
                    np.asarray(d["loop_pairs"]).reshape(-1, 2)},
        tried_pairs={(int(i), int(j)): int(v) for i, j, v in
                     np.asarray(d["tried_pairs"]).reshape(-1, 3)})
