"""The rotating unit's live chain, fed line by line, into ``SLAMSystem``.

The system of ``LivePipeline(LiveConfig(...), slam=SLAMSystem(...))``
(``tpu_slam_torch.pipeline.live``) driven as an offline replay of a
recorded survey: each stop's lines go through ``LivePipeline.feed_line``,
the method the socket path runs for every line (stage, copy, the line's
graph replay, the scan-complete read), at the encoder angles the sensor
part gives; the stop's last line completes the 3D scan, which
``SLAMSystem.step`` takes (on the configuration's engine, here the host
engine and its sparse map, with the keyframe store, loop sweeps, the
re-anchor and the map rebuild after a loop). The timed call is one stop:
its lines, its SLAM step and the read of the pose it arrived at.

Each stop runs with the program's recorder on (``tracing.enable()``), and
the driver adds up the spans of the live chain and the host engine
(``SPANS``) that the stop closed: ``counters()`` carries their seconds
under ``stages``, beside ``SLAMSystem.stage_seconds``, and the field
builds under ``host_field_builds``, so that the readers see the
unprofiled window. ``sweeps`` counts every loop sweep, ``solves`` those
that admitted a loop and solved the graph.

For the check the driver keeps, for each step, the scan the aggregator
emitted (the program's tensors, kept, not copied) and the line that
completed it, the odometry's pose before any re-anchor and its matched
fraction, the pose after the step, whether it stored a keyframe (and the
keyframe pose the next decision is measured from), whether it rebuilt
the map (and then the rebuilt map's voxel and point counts, its keys and
its moments, copied on the device) and, for each loop sweep, what
``slam``'s driver keeps. The check (``check``) follows the program from
those outputs.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from slambench.sensors import lms100_rotating as lms
from slambench.systems import from_json

# the spans the driver adds up (``counters()['stages']``)
SPANS = ("live.line", "host.field", "host.register", "host.insert")


class Driver:
    def __init__(self, config: Dict, device):
        from tpu_slam_torch.pipeline.config import SLAMConfig
        from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline
        from tpu_slam_torch.pipeline.slam import SLAMSystem

        if not hasattr(LivePipeline, "feed_line"):
            raise SystemExit("survey_slam: this program's LivePipeline has "
                             "no feed_line, the per-line entry it drives")
        self.config = config
        self.sensor = config["sensor"]
        self.cfg = from_json(SLAMConfig(), config["slam"])
        self.slam = SLAMSystem(self.cfg, device=device,
                               compiled=config["compiled"])
        self.pipe = LivePipeline(from_json(LiveConfig(), config["live"]),
                                 slam=self.slam, compiled=config["compiled"])
        self.zeros = np.zeros(self.sensor["beams"], np.float32)
        self.src: List[int] = []
        self.poses: List[np.ndarray] = []        # after each step
        self.odo: List[torch.Tensor] = []        # the odometry's, before
        self.frac: List[float] = []
        self.keyframe: List[bool] = []
        self.kf_pose: Dict[int, torch.Tensor] = {}
        self.rebuilt: Dict[int, Tuple] = {}
        self.clouds: List = []
        self.kf_steps: List[int] = []
        self.sweeps: List[Dict] = []
        self.emit_line: List[int] = []
        self.n = dict(keyframes=0, sweeps=0, solves=0, lines=0,
                      host_field_builds=0)
        self.span_s = dict.fromkeys(SPANS, 0.0)
        # the odometry step's own result, before the SLAM step re-anchors
        engine = self.slam.odometry
        real = engine.step

        def odometry_step(state, cloud):
            new, m = real(state, cloud)
            self._odo = new
            return new, m

        engine.step = odometry_step
        self._odo = None

    def start(self, cloud, index: int, init_pose: np.ndarray) -> None:
        self.pipe.warm_up()
        self.pipe.begin(init_pose, ang_step_deg=self.sensor["step_deg"])
        self.step(cloud, index)

    def step(self, cloud, index: int) -> np.ndarray:
        from tpu_slam_torch.utils import tracing

        ranges = lms.line_ranges(cloud.points, self.sensor)
        angles = lms.line_angles(self.sensor, index)
        prev = self.pipe.slam_state
        out, at = None, []
        with tracing.enable():
            n0 = len(tracing.spans())
            for j in range(len(ranges)):
                res = self.pipe.feed_line(ranges[j], self.zeros,
                                          float(angles[j]))
                if res is not None:
                    out = res
                    at.append(j + 1)
            self._add_spans(tracing.spans()[n0:])
        if len(at) != 1:
            raise RuntimeError(f"stop {index}: its {len(ranges)} lines "
                               f"completed {len(at)} scans")
        state = self.pipe.slam_state
        pose = state.odom.pose.cpu().numpy()
        scan, m = out
        s = len(self.src)
        self.n["lines"] += len(ranges)
        self.src.append(index)
        self.emit_line.append(at[0])
        self.poses.append(pose)
        self.odo.append(self._odo.pose)
        self.frac.append(float(m.matched_fraction))
        self.clouds.append((scan.points, scan.mask))
        self.keyframe.append(bool(m.is_keyframe))
        if state.odom.vmap is not self._odo.vmap:
            vm = state.odom.vmap
            self.rebuilt[s] = (
                torch.stack([vm.n_occupied().double(),
                             vm.count.double().sum()]),
                vm.keys.clone(),
                torch.cat([vm.count[:, None], vm.sum_pts,
                           vm.sum_outer.reshape(-1, 9)], dim=1))
        if m.is_keyframe:
            self.kf_pose[s] = state.last_kf_pose
            self._keyframe_stored(prev, s, m)
        return pose

    def _add_spans(self, spans) -> None:
        for sp in spans:
            if sp.name in self.span_s:
                self.span_s[sp.name] += 1e-9 * (sp.end_ns - sp.start_ns)
                self.n["host_field_builds"] += sp.name == "host.field"

    def _keyframe_stored(self, prev, s: int, m) -> None:
        st, cfg = self.pipe.slam_state, self.cfg
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

        st, loop = self.pipe.slam_state, self.cfg.loop
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
        """The driver's counts; ``stages``: ``SLAMSystem.stage_seconds``
        and the seconds of each of ``SPANS`` so far."""
        return dict(self.n, stages=dict(self.slam.stage_seconds,
                                        **self.span_s))

    def release(self) -> Dict:
        st = self.pipe.slam_state
        record = dict(src=list(self.src), poses=np.stack(self.poses),
                      emit_line=np.asarray(self.emit_line),
                      odo_poses=torch.stack(self.odo).cpu().numpy(),
                      frac=np.asarray(self.frac),
                      keyframe=np.asarray(self.keyframe),
                      kf_pose={s: p.cpu().numpy()
                               for s, p in self.kf_pose.items()},
                      rebuilt=self.rebuilt, clouds=self.clouds,
                      sweeps=self.sweeps,
                      info=dict(loops=st.n_loop_closures,
                                keyframes=self.n["keyframes"],
                                sweeps=self.n["sweeps"],
                                solves=self.n["solves"],
                                lines=self.n["lines"],
                                evictions=st.n_evictions))
        self.pipe = self.slam = None
        self.odo, self.clouds = [], []
        return record


def gates(frac: np.ndarray, odometry: Dict):
    """The host engine's accept and insert decisions from each step's
    matched fraction (the first step inserts whole)."""
    accepted = frac >= odometry["min_accept_fraction"]
    inserted = (accepted & (frac >= odometry["min_insert_fraction"])
                & (np.arange(len(frac)) % odometry["insert_every"] == 0))
    accepted[0] = inserted[0] = True
    return accepted, inserted


def keyframe_decisions(odo: np.ndarray, kf_pose: Dict[int, np.ndarray],
                       t_min: float, r_min: float) -> np.ndarray:
    """``SLAMSystem._is_keyframe`` on the host engine: the first step, then
    every step whose odometry pose lies ``t_min`` m (the translation of
    the relative pose's log) or ``r_min`` rad from the newest keyframe's
    pose, the pose the program kept for it (re-anchored after a loop), in
    float64."""
    from slambench.reference import se3

    out = np.zeros(len(odo), bool)
    last = None
    for i, p in enumerate(odo):
        if last is None:
            out[i] = True
        else:
            xi = se3.log(torch.as_tensor(np.linalg.inv(last) @ p,
                                         dtype=torch.float64)).numpy()
            out[i] = (np.linalg.norm(xi[:3]) >= t_min
                      or np.linalg.norm(xi[3:]) >= r_min)
        if out[i]:
            last = kf_pose.get(i, p).astype(np.float64)
    return out


def check(config: Dict, pts: torch.Tensor, msk: torch.Tensor,
          record: Dict, window_from: int, seed: int,
          device) -> Dict[str, float]:
    """The numbers compared.

    At every stop: ``trigger_mismatches`` (stops whose scan the program
    completed at another line than the reference's 1.1 pi trigger,
    ``aggregator.scan_lines``). At ``sample_scans`` window stops drawn
    from the seed: ``cloud_count_mismatches`` (stops whose aggregated
    cloud holds another number of points than the reference's assembly of
    the same lines) and ``cloud_gap_mm`` (the largest distance between a
    point of the program's cloud and the reference's, point by point in
    line order); ``pose_gap_p50_mm``, ``rot_gap_p50_mrad`` and their 80th
    percentiles (the program's odometry pose against the reference's
    registration of the stop from the same prediction and map) and
    ``gate_mismatches`` (accept or insert decisions that differ). The
    reference's map follows every step at the program's poses and insert
    flags, rebuilt from the keyframes at the optimized poses wherever a
    sweep admitted a loop: ``rebuild_mismatches`` counts the steps where
    one side rebuilt and the other did not, or the rebuilt maps differ in
    their numbers of voxels or of points, or in any voxel's key or moments
    (count, sum, outer products; the same segment sums in the same order
    on both sides, so bit for bit). ``keyframe_mismatches``: steps whose keyframe decision
    differs; ``nonfinite_poses``: window poses with a non-finite entry.
    Over ``sample_sweeps`` sweeps drawn from the seed, as ``slam``'s
    check: ``odom_edge_gap_mm``, ``candidate_mismatches``,
    ``loop_mismatches``, ``loop_gap_mm`` and ``graph_gap_mm``."""
    from slambench.reference import se3
    from slambench.reference.aggregator import (assemble, beam_directions,
                                                scan_lines)
    from slambench.reference.host_odometry import HostOdometryReference
    from slambench.reference.odometry import pose_gap
    from slambench.reference.pointcloud import PointCloud
    from slambench.reference.sweep import SweepReference, graph_edges
    from slambench.reference.voxel_map import rebuilt, same_map
    from slambench.systems.dense_odometry import sample_steps
    from slambench.systems.slam import kf_ate, pick_sweeps

    slam, live, sensor = config["slam"], config["live"], config["sensor"]
    odometry = slam["odometry"]
    chk = config["check"]
    dev = torch.device(device)
    src = record["src"]
    n_steps = len(src)
    odo = record["odo_poses"]
    P = torch.as_tensor(odo, device=dev)
    post = torch.as_tensor(record["poses"], device=dev)
    accepted, inserted = gates(record["frac"], odometry)
    sample = sample_steps(n_steps, window_from, chk["sample_scans"], seed)
    info = record.setdefault("info", {})
    out = dict(cloud_count_mismatches=0.0, cloud_gap_mm=0.0)
    agg = live["aggregator"]
    out["trigger_mismatches"] = float(sum(
        scan_lines(sensor["lines"], agg["angular_threshold"],
                   lms.line_step(sensor),
                   float(lms.line_angles(sensor, i)[0])) != k
        for i, k in zip(src, record["emit_line"])))

    def cloud(i):
        p, m = record["clouds"][i]
        return PointCloud(points=p, mask=m)

    # the aggregated clouds against the reference's assembly
    t0 = time.perf_counter()
    dirs = beam_directions(sensor["beams"], live["start_angle_deg"],
                           sensor["step_deg"])
    box = (agg["bb_x_down"], agg["bb_x_up"], agg["bb_y_down"],
           agg["bb_y_up"], agg["bb_z_down"], agg["bb_z_up"])
    for i in sample:
        mine = assemble(lms.line_ranges(pts[src[i]], sensor),
                        np.float32(lms.line_angles(sensor, src[i])), dirs,
                        live["range_min"], live["range_max"], box, dev)
        p, m = record["clouds"][i]
        theirs = p[m]
        if theirs.shape[0] != mine.shape[0]:
            out["cloud_count_mismatches"] += 1
            continue
        out["cloud_gap_mm"] = max(out["cloud_gap_mm"], 1e3 * float(
            torch.linalg.vector_norm(theirs - mine, dim=1).max()))
    info["check_clouds_s"] = time.perf_counter() - t0

    # the map replay and the sampled registrations
    t0 = time.perf_counter()
    sw = SweepReference(slam, dev)
    sweep_at = {s["step"]: s for s in record["sweeps"]}
    expect = {s["step"] for s in record["sweeps"]
              if s["post_loops"] - s["pre_loops"]}
    if not (slam["reanchor_after_loop"] and slam["rebuild_map_after_loop"]):
        expect = set()
    rebuild_mismatches = len(expect ^ set(record["rebuilt"]))
    ref = HostOdometryReference(odometry, dev)
    ref.start(cloud(0), P[0])
    want = set(sample)
    gaps = []
    for i in range(1, n_steps):
        mine = ref.follow(cloud(i), P[i], bool(inserted[i]),
                          register=i in want)
        if mine is not None:
            dt, dr = pose_gap(mine.T, P[i])
            if not (np.isfinite(dt) and np.isfinite(dr)):
                dt = dr = float("inf")
            gaps.append((dt, dr, mine.accepted != bool(accepted[i])
                         or mine.inserted != bool(inserted[i])))
        if i in expect and i in record["rebuilt"]:
            s = sweep_at[i]
            keys = s["kf_steps"][:s["n"]]
            vmap = rebuilt(ref.map_spec, odometry["map_capacity"],
                           s["post_graph"].poses[:s["n"]],
                           [sw.keyframe(k, cloud(k)) for k in keys], dev)
            totals, keys, mine_m = record["rebuilt"][i]
            n_occ, count = (float(v) for v in totals)
            same = same_map(vmap, keys.to(dev), mine_m.to(dev))
            rebuild_mismatches += int(vmap.n_occupied != n_occ
                                      or vmap.total_count() != count
                                      or not same)
            info.setdefault("rebuilds", []).append(
                [i, n_occ, vmap.n_occupied, count, same])
            ref.replace_map(vmap, post[i])
    info["check_replay_s"] = time.perf_counter() - t0
    info["sampled_gaps"] = [[i, 1e3 * g[0], 1e3 * g[1]]
                            for i, g in zip(sample, gaps)]
    dt = np.asarray([g[0] for g in gaps])
    dr = np.asarray([g[1] for g in gaps])
    window = record["poses"][window_from:]
    out.update(
        pose_gap_p50_mm=1e3 * float(np.median(dt)),
        rot_gap_p50_mrad=1e3 * float(np.median(dr)),
        pose_gap_p80_mm=1e3 * float(np.quantile(dt, 0.8)),
        rot_gap_p80_mrad=1e3 * float(np.quantile(dr, 0.8)),
        gate_mismatches=float(sum(g[2] for g in gaps)),
        nonfinite_poses=float(np.sum(~np.isfinite(window).all(axis=(1, 2)))),
        rebuild_mismatches=float(rebuild_mismatches),
        keyframe_mismatches=float(np.sum(
            keyframe_decisions(odo, record["kf_pose"],
                               slam["keyframe_translation"],
                               slam["keyframe_rotation"])
            != record["keyframe"])),
        odom_edge_gap_mm=0.0, candidate_mismatches=0.0, loop_mismatches=0.0,
        loop_gap_mm=0.0, graph_gap_mm=0.0)
    window_sweeps = [s for s in record["sweeps"] if s["step"] >= window_from]
    admitted = [len(s["post_loops"] - s["pre_loops"]) for s in window_sweeps]
    info.update(
        window_sweeps=len(window_sweeps),
        window_solves=sum(a > 0 for a in admitted),
        window_loops=sum(admitted),
        kf_ate_m=kf_ate(record["sweeps"], record["truth"], window_from))

    # the sampled sweeps, as slam's check
    t0 = time.perf_counter()

    def T(step):
        return P[step]

    def KF(step):
        """The pose the keyframe of ``step`` was kept at: re-anchored
        where that step closed a loop."""
        return torch.as_tensor(record["kf_pose"][step], device=dev)

    for s in pick_sweeps(record["sweeps"], window_from,
                         chk["sample_sweeps"], seed):
        n, keys = s["n"], s["kf_steps"]
        post_g = s["post_graph"]
        for key in keys:
            sw.keyframe(key, cloud(key))
        pre = s["pre_graph"].poses.clone()
        pre[n - 1] = T(keys[n - 1])
        live_e = post_g.edge_mask.cpu().numpy()
        ei, ej = post_g.edge_i.cpu().numpy(), post_g.edge_j.cpu().numpy()
        for e in np.nonzero(live_e & (ej == ei + 1))[0]:
            Z = se3.inverse(KF(keys[ei[e]])) @ T(keys[ej[e]])
            out["odom_edge_gap_mm"] = max(out["odom_edge_gap_mm"], 1e3 * float(
                torch.linalg.vector_norm(Z[:3, 3] - post_g.edge_T[e, :3, 3])))
        ci, cj = sw.candidates(keys, pre, s["pre_loops"], s["pre_tried"])
        mine = {(int(a), int(b)) for a, b in zip(ci, cj)}
        adm = s["post_loops"] - s["pre_loops"]
        theirs = adm | {p for p, v in s["post_tried"].items()
                        if v == n and s["pre_tried"].get(p) != n}
        out["candidate_mismatches"] += len(mine ^ theirs)
        if len(ci) == 0:
            continue
        Tr, accept = sw.verify(keys, pre, ci, cj)
        ours = {(int(a), int(b)) for a, b, ok in zip(ci, cj, accept) if ok}
        out["loop_mismatches"] += len(ours ^ adm)
        for k, (a, b) in enumerate(zip(ci, cj)):
            p = (int(a), int(b))
            if p not in ours or p not in adm:
                continue
            e = np.nonzero(live_e & (ei == a) & (ej == b))[0]
            out["loop_gap_mm"] = max(out["loop_gap_mm"], 1e3 * min(float(
                torch.linalg.vector_norm(Tr[k, :3, 3]
                                         - post_g.edge_T[i, :3, 3]))
                for i in e))
        if adm:
            opt = sw.solve(graph_edges(post_g), pre, n)
            d = opt[:n, :3, 3] - post_g.poses[:n, :3, 3]
            out["graph_gap_mm"] = max(out["graph_gap_mm"], 1e3 * float(
                torch.linalg.vector_norm(d, dim=-1).max()))
    info["check_sweeps_s"] = time.perf_counter() - t0
    return out
