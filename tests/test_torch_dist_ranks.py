"""Rank bodies of the distributed port's tests (no tests of its own).

``tpu_slam_torch.distributed.mesh.run_ranks`` spawns ranks that import a
body by its module path, so the bodies live here, in a module that imports
torch and the port only (never JAX): each takes the rank's mesh and numpy
inputs and returns numpy arrays.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpu_slam_torch.distributed import mesh as M


def _t(x, dtype=torch.float32, device="cpu"):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def collectives_body(mesh, per_rank):
    """Every collective on this rank's row of ``per_rank`` (D, ...)."""
    x = torch.as_tensor(per_rank[mesh.rank])
    left, right = M.halo_exchange(mesh, x[:2], x[-2:])
    return dict(all_reduce=M.all_reduce(mesh, x),
                reduce_scatter=M.reduce_scatter(mesh, x),
                all_gather=M.all_gather(mesh, x),
                shift_up=M.shift(mesh, x, 1), shift_down=M.shift(mesh, x, -1),
                halo_left=left, halo_right=right,
                calls=M.to_host(mesh.stats.calls))


def nccl_body(mesh):
    """The collectives on the rank's card (world size 1 on NCCL)."""
    x = torch.arange(12, dtype=torch.float32, device=mesh.device)
    left, right = M.halo_exchange(mesh, x[:2], x[-2:])
    return dict(all_reduce=M.all_reduce(mesh, x),
                reduce_scatter=M.reduce_scatter(mesh, x),
                all_gather=M.all_gather(mesh, x),
                shift=M.shift(mesh, x, 1), halo_left=left, halo_right=right,
                device=str(M.all_reduce(mesh, x).device),
                backend=mesh.backend, stats=mesh.stats.as_dict())


def mesh2d_body(mesh):
    """A (2, 2) layout: the rank's sums over each axis."""
    axes = M.make_mesh_2d(2, 2, device="cpu")
    x = torch.tensor([float(mesh.rank)])
    return dict(data=M.all_reduce(axes["data"], x),
                graph=M.all_reduce(axes["graph"], x),
                data_rank=axes["data"].rank, graph_rank=axes["graph"].rank,
                graph_up=M.shift(axes["graph"], x + 10.0, 1))


def heartbeat_body(mesh):
    from tpu_slam_torch.distributed.multihost import heartbeat

    healthy = heartbeat(mesh, timeout_s=30.0)
    t0 = time.monotonic()
    hung = heartbeat(mesh, timeout_s=0.5, _probe_fn=lambda x: time.sleep(30))
    hung_s = time.monotonic() - t0

    def _raise(x):
        raise ConnectionError("peer gone")

    raised = heartbeat(mesh, timeout_s=5.0, _probe_fn=_raise)
    return dict(healthy=healthy, hung=hung, hung_s=hung_s, raised=raised)


def initialize_body(env):
    """Join the group from the environment ``env`` alone (the backend
    named, as a deployment on one card's host would), then one
    all-reduce."""
    import torch.distributed as dist

    from tpu_slam_torch.distributed import multihost

    torch.set_num_threads(1)
    os.environ.update(env)
    before = (multihost.process_index(), multihost.process_count())
    active = multihost.initialize(backend="gloo")
    try:
        mesh = M.make_mesh(device="cpu")
        total = M.all_reduce(mesh, torch.tensor([1.0 + mesh.rank]))
        return dict(active=active, before=before,
                    index=multihost.process_index(),
                    count=multihost.process_count(),
                    coordinator=multihost.is_coordinator(),
                    backend=dist.get_backend(), total=M.to_host(total))
    finally:
        dist.destroy_process_group()


def icp_body(mesh, sp, sm, tp, tm, init_T, params):
    from tpu_slam_torch.distributed.registration_dist import \
        sharded_pairwise_icp

    res = sharded_pairwise_icp(mesh, _t(sp), _t(sm, torch.bool), _t(tp),
                               _t(tm, torch.bool), _t(init_T), params)
    return dict(T=res.T, iterations=res.iterations, error=res.error,
                matched_fraction=res.matched_fraction,
                converged=res.converged)


def graph_body(mesh, cases):
    """[(name, graph numpy dict, solver, params)] -> {name: (poses, chi2)};
    solver "pcg" (edge-sharded) or "schur"."""
    from tpu_slam_torch.distributed.pose_graph_dist import \
        optimize_pose_graph_sharded
    from tpu_slam_torch.distributed.schur import optimize_pose_graph_schur

    from chip_smoke import _graph_torch

    out = {}
    for name, g, solver, params in cases:
        graph = _graph_torch(g, "cpu")
        if solver == "pcg":
            res, chi2 = optimize_pose_graph_sharded(mesh, graph, params)
        else:
            res, chi2 = optimize_pose_graph_schur(mesh, graph, params)
        out[name] = dict(poses=res.poses, chi2=chi2)
    out["calls"] = M.to_host(mesh.stats.calls)
    return out


def map_body(mesh, pts, capacity, shard_capacity, spec, stamps, cases):
    """Insert the clouds ``pts`` (world frame, one a stamp), gather the
    stacked map, then run each registration case
    (name, source points, params, center) on it."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.distributed import map_shard as ms

    smap = ms.empty_sharded_map(mesh, shard_capacity)
    for p, st in zip(pts, stamps):
        cloud = PointCloud.from_points_host(p, capacity=capacity,
                                            device="cpu")
        smap = ms.insert_cloud_sharded(mesh, smap, cloud, spec, st)
    out = dict(stacked=ms.to_stacked(mesh, smap),
               local_keys=smap.local(mesh.rank).keys)
    again = ms.from_stacked(mesh, M.to_host(out["stacked"]))
    out["roundtrip_equal"] = all(
        torch.equal(getattr(again.shard, f), getattr(smap.shard, f))
        for f in ms.MAP_FIELDS)
    for name, src_pts, params, center in cases:
        src = PointCloud.from_points_host(src_pts, capacity=capacity,
                                          device="cpu")
        mesh.stats.reset()
        res = ms.ndt_register_sharded(
            mesh, src, smap, spec, params=params,
            center=None if center is None else _t(center))
        out[name] = dict(T=res.T, score=res.score,
                         matched=res.matched_fraction,
                         iterations=res.iterations,
                         converged=res.converged,
                         calls=M.to_host(mesh.stats.calls))
    return out


def dense_body(mesh, rows, origin_cell, pose, scans, spec, dims, cases):
    """Steps of dense_step_sharded from this rank's x-chunk of ``rows``,
    for each case (name, params, gate keywords): per step (pose, metrics),
    and the rank's final chunk."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.distributed.dense_shard import dense_step_sharded

    s = dims[0] // mesh.size
    per = s * dims[1] * dims[2]
    out = {}
    for name, params, gates in cases:
        r = _t(rows[mesh.rank * per:(mesh.rank + 1) * per])
        oc = _t(origin_cell, torch.int32)
        T = _t(pose)
        delta = torch.eye(4)
        poses, metrics = [], []
        for pts, mask in scans:
            scan = PointCloud(points=_t(pts), mask=_t(mask, torch.bool))
            r, T, delta, m = dense_step_sharded(mesh, r, oc, T, delta, scan,
                                                spec, dims, params, **gates)
            poses.append(T)
            metrics.append(m)
        out[name] = dict(poses=torch.stack(poses),
                         metrics=torch.stack(metrics), rows=r)
    return out


def compiled_body(mesh, rows, origin_cell, pose, scans, spec, dims, params,
                  graph, graph_params):
    """The sharded dense step over ``scans`` and the Schur solve of
    ``graph`` on both forms (``compiled=False``, then the default: on NCCL
    the captured one), every captured call under sync-debug "error": each
    form's results, the captures made, the calls checked."""
    import chip_smoke
    from chip_smoke import _graph_torch
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.distributed import dense_shard, schur

    dev = mesh.device
    s = dims[0] // mesh.size
    per = s * dims[1] * dims[2]
    g = _graph_torch(graph, dev)
    out = dict(captures_before=len(dense_shard._steps) + len(schur._solves))
    for form, compiled in (("eager", False), ("captured", None)):
        r = _t(rows[mesh.rank * per:(mesh.rank + 1) * per], device=dev)
        oc = _t(origin_cell, torch.int32, dev)
        T, delta = _t(pose, device=dev), torch.eye(4, device=dev)
        steps = []
        with chip_smoke.replays_sync_checked() as chk:
            for pts, mask in scans:
                scan = PointCloud(points=_t(pts, device=dev),
                                  mask=_t(mask, torch.bool, dev))
                r, T, delta, m = dense_shard.dense_step_sharded(
                    mesh, r, oc, T, delta, scan, spec, dims, params,
                    compiled=compiled)
                steps.append(torch.cat([r.reshape(-1), T.reshape(-1),
                                        delta.reshape(-1), m]))
            solves = [schur.optimize_pose_graph_schur(
                mesh, g, graph_params, compiled=compiled) for _ in range(2)]
        out[form] = dict(steps=torch.stack(steps),
                         poses=torch.stack([p.poses for p, _ in solves]),
                         chi2=torch.stack([c for _, c in solves]),
                         checked=chk.calls)
    out["captures"] = (len(dense_shard._steps) + len(schur._solves)
                       - out["captures_before"])
    return out
