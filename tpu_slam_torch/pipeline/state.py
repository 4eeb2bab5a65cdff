"""Carry odometry/SLAM state and configuration across engines as arrays.

The system has no weights; what two engines must share to continue from
the same point is their state: ``DenseOdomState`` (pose, last delta, both
moment windows, the occupancy layer, scan index, last metrics), the host
engine's ``OdometryState`` (pose, last delta, the voxel map's five
arrays, scan index, the occupancy grid, the scrolling-window offset) and,
for SLAM, the pose graph, the keyframe buffers, the counters and the loop
bookkeeping. These helpers
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
from tpu_slam_torch.mapping.occupancy import OccupancyGrid
from tpu_slam_torch.mapping.voxel_map import VoxelMap
from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
from tpu_slam_torch.pipeline.odometry import OdometryState
from tpu_slam_torch.pipeline.odometry_dense import DenseOdomState
from tpu_slam_torch.registration.icp import ICPParams
from tpu_slam_torch.registration.ndt import NDTParams

STATE_KEYS = ("pose", "last_delta", "grid_rows", "grid_origin_cell",
              "wide_rows", "wide_origin_cell", "occ_rows", "occ_origin_cell",
              "scan_index", "last_metrics")

# NDTParams fields of the reference that select TPU gather/layout tiers;
# the port does not have those tiers and ignores them
_TPU_TIER_FIELDS = ("dense_lookup_max_bits", "pack_budget_mb",
                    "pack_any_backend")
# the reference's terms_impl values -> the port's: its Pallas kernel
# (compiled or interpreted) is the port's kernel path
_TERMS_IMPL = {"auto": "auto", "pallas": "auto", "pallas_interpret": "auto",
               "xla": "xla"}


def state_from_numpy(d: Dict[str, np.ndarray], dims: Tuple[int, int, int],
                     device) -> DenseOdomState:
    """DenseOdomState on ``device`` from a dict of arrays (STATE_KEYS;
    the ``wide_*`` and ``occ_*`` entries may be absent or None)."""
    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    dims = tuple(dims)

    def window(name):
        if d.get(name + "_rows") is None:
            return None
        return DenseMomentGrid(rows=t(name + "_rows", torch.float32),
                               origin_cell=t(name + "_origin_cell",
                                             torch.int32), dims=dims)

    return DenseOdomState(
        pose=t("pose", torch.float32), last_delta=t("last_delta",
                                                    torch.float32),
        grid=window("grid"),
        scan_index=t("scan_index", torch.int32),
        last_metrics=t("last_metrics", torch.float32), wide=window("wide"),
        occ=window("occ"))


def state_to_numpy(state: DenseOdomState) -> Dict[str, np.ndarray]:
    """The state's tensors as host arrays under STATE_KEYS."""
    def a(x):
        return None if x is None else x.detach().cpu().numpy()

    d = {"pose": a(state.pose), "last_delta": a(state.last_delta),
         "scan_index": a(state.scan_index),
         "last_metrics": a(state.last_metrics)}
    for name, w in (("grid", state.grid), ("wide", state.wide),
                    ("occ", state.occ)):
        d[name + "_rows"] = None if w is None else a(w.rows)
        d[name + "_origin_cell"] = None if w is None else a(w.origin_cell)
    return d


HOST_STATE_KEYS = ("pose", "last_delta", "map_keys", "map_count",
                   "map_sum_pts", "map_sum_outer", "map_stamp", "scan_index",
                   "occ_keys", "occ_log_odds", "map_offset")
_MAP_FIELDS = ("keys", "count", "sum_pts", "sum_outer", "stamp")


def host_state_to_numpy(state: OdometryState) -> Dict[str, np.ndarray]:
    """The host engine's state as host arrays under HOST_STATE_KEYS
    (``occ_*`` None without occupancy, ``map_offset`` None off the
    scrolling window; the cached field is derived, not state)."""
    def a(x):
        return x.detach().cpu().numpy()

    d = {"pose": a(state.pose), "last_delta": a(state.last_delta),
         "scan_index": np.int64(state.scan_index),
         "map_offset": (None if state.map_offset is None
                        else np.asarray(state.map_offset, np.float64))}
    for f in _MAP_FIELDS:
        d["map_" + f] = a(getattr(state.vmap, f))
    d["occ_keys"] = None if state.occ is None else a(state.occ.keys)
    d["occ_log_odds"] = None if state.occ is None else a(state.occ.log_odds)
    return d


def host_state_from_numpy(d: Dict[str, np.ndarray],
                          device) -> OdometryState:
    """OdometryState on ``device`` from a dict of HOST_STATE_KEYS arrays
    (the field cache starts empty: the next step rebuilds it)."""
    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    vmap = VoxelMap(**{f: t("map_" + f, torch.int32 if f == "keys"
                            else torch.float32) for f in _MAP_FIELDS})
    occ = None
    if d.get("occ_keys") is not None:
        occ = OccupancyGrid(keys=t("occ_keys", torch.int32),
                            log_odds=t("occ_log_odds", torch.float32))
    offset = d.get("map_offset")
    return OdometryState(
        pose=t("pose", torch.float32),
        last_delta=t("last_delta", torch.float32), vmap=vmap,
        scan_index=int(d["scan_index"]), occ=occ,
        map_offset=None if offset is None else np.array(offset,
                                                        np.float64))


def config_from_dict(d: dict) -> OdometryConfig:
    """OdometryConfig from ``dataclasses.asdict`` of an odometry config.

    Unknown fields raise (TypeError from the dataclass), except the NDT
    fields that only select the reference's TPU tiers; the reference's
    Pallas ``terms_impl`` values become the port's kernel path ("auto").
    """
    d = dict(d)
    ndt = {k: v for k, v in dict(d.pop("ndt")).items()
           if k not in _TPU_TIER_FIELDS}
    if ndt.get("window_dims") is not None:
        ndt["window_dims"] = tuple(ndt["window_dims"])
    if "terms_impl" in ndt:
        ndt["terms_impl"] = _TERMS_IMPL[ndt["terms_impl"]]
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
    (the dense engine's STATE_KEYS or the host engine's HOST_STATE_KEYS;
    absent before the dense engine's first scan, and the entries of
    absent windows or grids left out), the graph under ``graph_<field>``,
    the keyframe buffers, counters, archived poses and the loop
    bookkeeping (``loop_pairs`` (L, 2) and ``tried_pairs`` (T, 3) rows
    (i, j, n), sorted)."""
    d = {}
    if state.odom is not None:
        to_numpy = (host_state_to_numpy
                    if isinstance(state.odom, OdometryState)
                    else state_to_numpy)
        d.update({"odom_" + k: v for k, v in to_numpy(state.odom).items()
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
    ``dims`` is the dense window shape (unused for the host engine's state,
    which the ``odom_map_keys`` entry marks, and when there is no odometry
    state yet)."""
    from tpu_slam_torch.pipeline.slam import SLAMState

    def t(key, dtype):
        return torch.as_tensor(np.array(d[key]), dtype=dtype, device=device)

    odom = None
    if "odom_pose" in d:
        sub = {k[5:]: v for k, v in d.items() if k.startswith("odom_")}
        odom = (host_state_from_numpy(sub, device) if "map_keys" in sub
                else state_from_numpy(sub, dims, device))
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
