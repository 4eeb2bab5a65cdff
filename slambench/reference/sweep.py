"""Plain re-computation of one loop sweep of ``SLAMSystem.step``.

From the raw scans of the keyframes, the node poses before the sweep and
the loop pairs admitted and refused before it, the sweep as the frozen
copies compute it: each keyframe's cloud (the downsampled scan's first P
rows), its scan-context descriptor and its normals; the proximity and
scan-context candidates; the batched symmetric ICP verification; and the
Gauss-Newton PCG solve of a graph.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from slambench.reference.downsample import voxel_downsample
from slambench.reference.icp import ICPParams
from slambench.reference.loop_closure import (LoopClosureParams,
                                              propose_candidates,
                                              verify_candidates)
from slambench.reference.normals import estimate_normals
from slambench.reference.pointcloud import PAD_COORD, PointCloud
from slambench.reference.pose_graph import (GraphSolveParams, PoseGraph,
                                            optimize_pose_graph)
from slambench.reference.scan_context import (ScanContextParams,
                                              propose_sc_candidates,
                                              scan_context)
from slambench.reference.voxel_hash import VoxelGridSpec


def loop_params(values: Dict) -> LoopClosureParams:
    kw = dict(values)
    kw["icp"] = ICPParams(**kw["icp"])
    kw["sc"] = ScanContextParams(**kw["sc"])
    return LoopClosureParams(**kw)


class SweepReference:
    """The loop sweeps of one SLAM configuration (``slam``: the
    configuration file's ``slam`` object)."""

    def __init__(self, slam: Dict, device):
        self.cfg = slam
        self.device = torch.device(device)
        self.loop = loop_params(slam["loop"])
        self.graph_params = GraphSolveParams(**slam["graph"])
        odo = slam["odometry"]
        self.scan_spec = VoxelGridSpec.centered(
            leaf=odo["downsample_leaf"], half_extent=odo["map_half_extent"])
        self.scan_capacity = odo["scan_capacity"]
        self.K = slam["keyframe_capacity"]
        self.P = slam["keyframe_cloud_capacity"]
        self._rows: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        self._desc: Dict[int, torch.Tensor] = {}
        self._normals: Dict[int, torch.Tensor] = {}

    def keyframe(self, key: int, cloud: PointCloud
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The keyframe cloud of a raw scan: the downsampled scan's first P
        points and mask, padded to P rows (kept by ``key``)."""
        if key not in self._rows:
            s = voxel_downsample(cloud, self.scan_spec,
                                 capacity=self.scan_capacity)
            pts, msk = s.points, s.mask
            n = pts.shape[0]
            if n >= self.P:
                pts, msk = pts[:self.P], msk[:self.P]
            else:
                pts = torch.cat([pts, pts.new_full((self.P - n, 3),
                                                   PAD_COORD)])
                msk = torch.cat([msk, msk.new_zeros(self.P - n)])
            self._rows[key] = (pts, msk)
            self._desc[key] = scan_context(
                PointCloud(points=pts, mask=msk,
                           attrs=torch.zeros_like(msk, dtype=torch.float32
                                                  )[:, None]), self.loop.sc)
        return self._rows[key]

    def normals(self, key: int) -> torch.Tensor:
        if key not in self._normals:
            self._normals[key] = estimate_normals(*self._rows[key])
        return self._normals[key]

    def candidates(self, keys, poses: torch.Tensor, loop_pairs: set,
                   tried_pairs: dict) -> Tuple[np.ndarray, np.ndarray]:
        """``SLAMSystem._candidates`` for the newest of the n = len(keys)
        keyframes: proximity pairs, fresh ones only, then the scan-context
        matches within the drift budget."""
        lp = self.loop
        n = len(keys)
        positions = poses[:, :3, 3].cpu().numpy()
        ci, cj = propose_candidates(positions, n, lp)
        cool = lp.retry_cooldown * max(1, self.cfg["loop_every"])

        def fresh(i, j):
            p = (int(i), int(j))
            if p in loop_pairs:
                return False
            return n - tried_pairs.get(p, -10**9) >= cool

        keep = np.asarray([(j - i) >= lp.min_index_gap and fresh(i, j)
                           for i, j in zip(ci, cj)], bool).reshape(-1)
        ci, cj = ci[keep], cj[keep]
        if lp.use_scan_context and n > lp.min_index_gap + 1:
            db = torch.zeros((self.K, lp.sc.n_rings, lp.sc.n_sectors),
                             dtype=torch.float32, device=self.device)
            for i, key in enumerate(keys):
                db[i] = self._desc[key]
            si, sj = propose_sc_candidates(db[n - 1], db, n - 1, n,
                                           lp.sc_max_distance,
                                           lp.min_index_gap, lp.sc_top_k)
            pairs = {(int(a), int(b)) for a, b in zip(ci, cj)}
            new = [(a, b) for a, b in zip(si, sj)
                   if (int(a), int(b)) not in pairs and fresh(a, b)
                   and np.linalg.norm(positions[int(a)] - positions[int(b)])
                   <= lp.sc_max_pose_distance]
            if new:
                fi, fj = zip(*new)
                ci = np.concatenate([ci, np.asarray(fi, np.int32)])
                cj = np.concatenate([cj, np.asarray(fj, np.int32)])
                ci, cj = ci[:lp.max_candidates], cj[:lp.max_candidates]
        return ci, cj

    def verify(self, keys, poses: torch.Tensor, ci: np.ndarray,
               cj: np.ndarray):
        """The batched symmetric ICP of the pairs (ci, cj): (T (B, 4, 4),
        accept (B,) numpy)."""
        pts = torch.full((self.K, self.P, 3), PAD_COORD, dtype=torch.float32,
                         device=self.device)
        msk = torch.zeros((self.K, self.P), dtype=torch.bool,
                          device=self.device)
        nrm = torch.zeros_like(pts)
        for i in set(int(a) for a in ci) | set(int(b) for b in cj):
            pts[i], msk[i] = self._rows[keys[i]]
            if self.loop.plane_verify:
                nrm[i] = self.normals(keys[i])
        res, accept = verify_candidates(
            pts, msk, poses, ci, cj, self.loop,
            clouds_normals=nrm if self.loop.plane_verify else None)
        return res.T, accept.cpu().numpy()

    def solve(self, graph_tensors: Dict, poses: torch.Tensor, n: int
              ) -> torch.Tensor:
        """The GN-PCG solve of the graph of ``graph_tensors``' edges from
        ``poses``; returns the optimized poses."""
        g = PoseGraph(poses=poses, n_nodes=n, **graph_tensors)
        out, _ = optimize_pose_graph(g, self.graph_params)
        return out.poses


def graph_edges(graph) -> Dict[str, torch.Tensor]:
    """A graph's edge tensors by field name (any object with them)."""
    return {f.name: getattr(graph, f.name)
            for f in dataclasses.fields(PoseGraph)
            if f.name.startswith("edge_")}
