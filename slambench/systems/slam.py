"""``SLAMSystem.step`` on the dense engine, fed one scan at a time.

The timed call is one ``step``: the odometry step and its pose read, and
on a keyframe the keyframe store and, every ``loop_every`` keyframes, a
loop sweep (candidates, the batched ICP verification, the graph solve).
The pose the step has read back is the scan's pose on the host.

For the check the driver keeps, for each step, the pose, the odometry's
metrics row (on the device, read once the window has closed) and whether
it stored a keyframe; for each loop sweep the graph before and after it
(the program's tensors, kept, not copied) and the loop pairs it admitted
and refused. The check then replays the odometry as ``dense_odometry``
does, recomputes every keyframe decision from the poses, and at a sample
of the window's sweeps drawn from the seed recomputes the sweep: the
candidates, the verification (accepted pairs and their transforms) and
the solve of the sweep's graph from the poses before it; the odometry
edges of that graph are recomputed from the poses.

Following the program's own trajectory cannot see a run that drifts,
admits fewer loops and so runs faster: every step of it is sound. The
window's solves, admitted loops and the keyframes' error against the route
(``kf_ate``) go to the run's info line, and the per-layer metric
``scans_per_solve`` reads the loop-closure work the rate was paid with.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from slambench.systems import from_json
from slambench.systems.dense_odometry import odometry_numbers


class Driver:
    def __init__(self, config: Dict, device):
        from tpu_slam_torch.pipeline.config import SLAMConfig
        from tpu_slam_torch.pipeline.slam import SLAMSystem

        self.config = config
        self.cfg = from_json(SLAMConfig(), config["slam"])
        self.slam = SLAMSystem(self.cfg, device=device,
                               compiled=config["compiled"])
        self.state = None
        self.src: List[int] = []
        self.poses: List[np.ndarray] = []
        self.rows: List[torch.Tensor] = []
        self.keyframe: List[bool] = []
        self.kf_steps: List[int] = []      # the step of each live keyframe
        self.sweeps: List[Dict] = []
        self.n = dict(keyframes=0, sweeps=0, solves=0)

    def start(self, cloud, index: int, init_pose: np.ndarray) -> None:
        self.slam.warm_up(cloud)
        self.state = self.slam.init_state(init_pose)
        self.step(cloud, index)

    def step(self, cloud, index: int) -> np.ndarray:
        prev = self.state
        self.state, m = self.slam.step(prev, cloud)
        pose = self.slam.last_pose_np
        s = len(self.src)
        self.src.append(index)
        self.poses.append(pose)
        self.rows.append(self.state.odom.last_metrics)
        self.keyframe.append(bool(m.is_keyframe))
        if m.is_keyframe:
            self._keyframe_stored(prev, s, m)
        return pose

    def _keyframe_stored(self, prev, s: int, m) -> None:
        st, cfg = self.state, self.cfg
        evicted = st.n_evictions - prev.n_evictions
        del self.kf_steps[:evicted]
        self.kf_steps.append(s)
        self.n["keyframes"] += 1
        n = st.n_keyframes
        if not (n % cfg.loop_every == 0 and n > cfg.loop.min_index_gap):
            return
        self.n["sweeps"] += 1
        self.n["solves"] += int(m.n_loop_closures > 0)
        self.sweeps.append(dict(
            step=s, n=n, evicted=evicted, kf_steps=list(self.kf_steps),
            pre_graph=prev.graph, post_graph=st.graph,
            pre_loops=set(prev.loop_pairs), pre_tried=dict(prev.tried_pairs),
            post_loops=set(st.loop_pairs), post_tried=dict(st.tried_pairs)))

    def warm(self) -> None:
        """The verification's batched ICP captured at every batch size
        from 1 to ``max_candidates``, on the state's own keyframes."""
        from tpu_slam_torch.graph.loop_closure import verify_candidates

        st, loop = self.state, self.cfg.loop
        if not self.config["compiled"]:
            return
        for b in range(1, loop.max_candidates + 1):
            ci = np.zeros(b, np.int32)
            cj = np.arange(1, b + 1, dtype=np.int32)
            verify_candidates(st.kf_points, st.kf_mask, st.graph.poses, ci,
                              cj, loop,
                              clouds_normals=(st.kf_normals
                                              if loop.plane_verify else None),
                              compiled=True)

    def counters(self) -> Dict:
        return dict(self.n, stages=dict(self.slam.stage_seconds))

    def release(self) -> Dict:
        flags = torch.stack(self.rows[1:]).cpu().numpy()
        record = dict(src=list(self.src), poses=np.stack(self.poses),
                      accepted=np.r_[True, flags[:, 2] > 0.5],
                      inserted=np.r_[True, flags[:, 3] > 0.5],
                      keyframe=np.asarray(self.keyframe),
                      sweeps=self.sweeps,
                      info=dict(loops=self.state.n_loop_closures,
                                keyframes=self.n["keyframes"],
                                sweeps=self.n["sweeps"],
                                solves=self.n["solves"],
                                evictions=self.state.n_evictions))
        self.slam = self.state = None
        self.rows = []
        return record


def keyframe_decisions(poses: np.ndarray, t_min: float, r_min: float
                       ) -> np.ndarray:
    """``SLAMSystem._is_keyframe`` on the dense engine over a run's poses:
    the first pose, then every pose that moved ``t_min`` m or turned
    ``r_min`` rad from the last keyframe's."""
    out = np.zeros(len(poses), bool)
    last = None
    for i, p in enumerate(poses):
        if last is None:
            out[i] = True
        else:
            d = np.linalg.inv(last) @ p
            t = float(np.linalg.norm(d[:3, 3]))
            c = np.clip((np.trace(d[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
            out[i] = t >= t_min or float(np.arccos(c)) >= r_min
        if out[i]:
            last = p
    return out


def check(config: Dict, pts: torch.Tensor, msk: torch.Tensor,
          record: Dict, window_from: int, seed: int,
          device) -> Dict[str, float]:
    """The numbers compared: the odometry's (``odometry_numbers``),
    ``keyframe_mismatches`` (steps whose keyframe decision differs), and
    over the sampled sweeps ``odom_edge_gap_mm`` (the graph's odometry
    edges against the poses), ``candidate_mismatches`` (pairs verified by
    one side only), ``loop_mismatches`` (pairs accepted by one side only),
    ``loop_gap_mm`` (an accepted pair's transform) and ``graph_gap_mm``
    (an optimized node). The window's sweeps, solves, admitted loops and
    ``kf_ate`` go to ``record['info']``."""
    from slambench.reference import se3
    from slambench.reference.pointcloud import PointCloud
    from slambench.reference.sweep import SweepReference, graph_edges

    slam = config["slam"]
    chk = config["check"]
    dev = torch.device(device)
    poses = record["poses"]
    out = odometry_numbers(slam["odometry"], chk, pts, msk, record,
                           window_from, seed, dev)
    out.update(
        keyframe_mismatches=float(np.sum(
            keyframe_decisions(poses, slam["keyframe_translation"],
                               slam["keyframe_rotation"])
            != record["keyframe"])),
        odom_edge_gap_mm=0.0, candidate_mismatches=0.0, loop_mismatches=0.0,
        loop_gap_mm=0.0, graph_gap_mm=0.0)
    window = [s for s in record["sweeps"] if s["step"] >= window_from]
    admitted = [len(s["post_loops"] - s["pre_loops"]) for s in window]
    record["info"].update(
        window_sweeps=len(window), window_solves=sum(a > 0 for a in admitted),
        window_loops=sum(admitted),
        kf_ate_m=kf_ate(record["sweeps"], record["truth"], window_from))
    t_sweeps = time.perf_counter()

    sw = SweepReference(slam, dev)
    src = record["src"]

    def T(step):
        return torch.as_tensor(poses[step], device=dev)

    for s in pick_sweeps(record["sweeps"], window_from,
                         chk["sample_sweeps"], seed):
        n, keys = s["n"], s["kf_steps"]
        post = s["post_graph"]
        for key in keys:
            sw.keyframe(key, PointCloud(points=pts[src[key]],
                                        mask=msk[src[key]]))
        # the node poses before the sweep: the graph's, and the new node
        pre = s["pre_graph"].poses.clone()
        pre[n - 1] = T(keys[n - 1])
        # the graph's odometry edges against the poses that made them
        live = post.edge_mask.cpu().numpy()
        ei, ej = post.edge_i.cpu().numpy(), post.edge_j.cpu().numpy()
        for e in np.nonzero(live & (ej == ei + 1))[0]:
            Z = se3.inverse(T(keys[ei[e]])) @ T(keys[ej[e]])
            out["odom_edge_gap_mm"] = max(out["odom_edge_gap_mm"], 1e3 * float(
                torch.linalg.vector_norm(Z[:3, 3] - post.edge_T[e, :3, 3])))
        ci, cj = sw.candidates(keys, pre, s["pre_loops"], s["pre_tried"])
        mine = {(int(a), int(b)) for a, b in zip(ci, cj)}
        admitted = s["post_loops"] - s["pre_loops"]
        theirs = admitted | {p for p, v in s["post_tried"].items()
                             if v == n and s["pre_tried"].get(p) != n}
        out["candidate_mismatches"] += len(mine ^ theirs)
        if len(ci) == 0:
            continue
        Tr, accept = sw.verify(keys, pre, ci, cj)
        ours = {(int(a), int(b)) for a, b, ok in zip(ci, cj, accept) if ok}
        out["loop_mismatches"] += len(ours ^ admitted)
        for k, (a, b) in enumerate(zip(ci, cj)):
            p = (int(a), int(b))
            if p not in ours or p not in admitted:
                continue
            e = np.nonzero(live & (ei == a) & (ej == b))[0]
            out["loop_gap_mm"] = max(out["loop_gap_mm"], 1e3 * min(float(
                torch.linalg.vector_norm(Tr[k, :3, 3] - post.edge_T[i, :3, 3]))
                for i in e))
        if admitted:
            opt = sw.solve(graph_edges(post), pre, n)
            d = opt[:n, :3, 3] - post.poses[:n, :3, 3]
            out["graph_gap_mm"] = max(out["graph_gap_mm"], 1e3 * float(
                torch.linalg.vector_norm(d, dim=-1).max()))
    record["info"]["check_sweeps_s"] = time.perf_counter() - t_sweeps
    return out


def kf_ate(sweeps: List[Dict], truth: np.ndarray, window_from: int
           ) -> float:
    """RMSE (m) of the node positions of the window's last graph that a
    solve optimized against the route's positions at the nodes' scans, in
    the route's frame (the run starts at the route's first pose; no
    alignment); inf where the window solved no graph."""
    solved = [s for s in sweeps if s["step"] >= window_from
              and s["post_loops"] - s["pre_loops"]]
    if not solved:
        return float("inf")
    s = solved[-1]
    est = s["post_graph"].poses[:s["n"], :3, 3].double().cpu().numpy()
    gt = truth[np.asarray(s["kf_steps"][:s["n"]])][:, :3, 3]
    return float(np.sqrt(np.mean(np.sum((est - gt) ** 2, axis=1))))


def pick_sweeps(sweeps: List[Dict], window_from: int, k: int, seed: int
                ) -> List[Dict]:
    """k of the window's sweeps drawn from the seed (none that evicted
    keyframes in the same step), one that admitted a loop among them where
    the window has one."""
    pool = [s for s in sweeps if s["step"] >= window_from
            and s["evicted"] == 0]
    if not pool:
        return []
    rng = np.random.default_rng(seed + 1)
    pick = sorted(rng.choice(len(pool), size=min(k, len(pool)),
                             replace=False).tolist())
    solving = [i for i, s in enumerate(pool)
               if s["post_loops"] - s["pre_loops"]]
    if solving and not any(i in solving for i in pick):
        pick[0] = int(rng.choice(solving))
    return [pool[i] for i in sorted(set(pick))]
