"""The reference number of ``chip_smoke.py``'s host_odometry phase.

Run as a script, this measures tpu_slam's LidarOdometry (the reference) on
config 2's route on the CPU: the 24 scans of ``chip_smoke.city_scans``
(65,536 rays each) copied into numpy, ``chip_smoke.config2()``'s
odometry configuration, the reference's kernel path
(``terms_impl="pallas_interpret"``). Its Pallas terms pass is replaced by
``compact_raster_reference``: the per-neighbour code of
``ndt_terms_raster_reference`` run over the raster's occupied slots only,
because the dense form holds (G*Q, ...) arrays, over 40 GB at the
(192, 192, 32) window. With ``--port`` it runs the port's LidarOdometry
on the same scans on the CPU too. It prints one JSON line per engine
(ATE, mean matched fraction, mean iterations, field builds, voxels)::

    python -m tests.test_torch_host_reference [--port] [--cases]

With ``--cases`` it also runs the reference's own host-engine tests on its
kernel path (the same terms pass): the outdoor ring and the pyramid's
capture range (tests/test_outdoor.py), and point-to-point ICP on the
office arc (tests/test_pipeline.py), printing the worst translation
errors and ATEs that ``chip_smoke.py`` holds the card to.

As a test it holds ``compact_raster_reference`` to
``ndt_terms_raster_reference`` on a small window: H and b within 1e-6 of
their largest magnitude, cost and the matched count exact.
"""

import json
import sys
import time

import jax.numpy as jnp
import numpy as np

import tpu_slam.kernels.ndt_terms as j_terms

SLOT_CAP = 65536             # >= any scan's occupied raster slots


def compact_raster_reference(raster, planes, T, gamma, max_corr_dist, dims,
                             q_cap, interpret=False, owned_planes=None,
                             plane_flags=None):
    """ndt_terms_raster_reference's sums over the occupied slots only."""
    wx, wy, wz = dims
    _, _, wz8, _ = j_terms._split_dims(dims)
    g = wx * wy * wz
    full = j_terms.raster_to_slots(raster, dims, q_cap)
    sel = jnp.nonzero(full[:, 3] > 0.5, size=SLOT_CAP,
                      fill_value=g * q_cap)[0]
    ra = jnp.concatenate([full, jnp.zeros((1, 4), jnp.float32)])[sel]
    pts = ra[:, :3] @ T[:3, :3].T + T[:3, 3]
    w = ra[:, 3]
    rows = jnp.transpose(planes.reshape(wx, 16, 8, wy, wz8),
                         (0, 3, 4, 2, 1)).reshape(g, 16)
    cell = jnp.minimum(sel, g * q_cap - 1).astype(jnp.int32) // q_cap
    cx, cy, cz = cell // (wy * wz), (cell // wz) % wy, cell % wz
    n = SLOT_CAP
    zero = jnp.zeros(n)
    phat = jnp.stack([jnp.stack([zero, -pts[:, 2], pts[:, 1]], -1),
                      jnp.stack([pts[:, 2], zero, -pts[:, 0]], -1),
                      jnp.stack([-pts[:, 1], pts[:, 0], zero], -1)], -2)
    J = jnp.concatenate([jnp.broadcast_to(jnp.eye(3, dtype=jnp.float32),
                                          (n, 3, 3)), -phat], axis=2)
    H = jnp.zeros((6, 6), jnp.float32)
    b = jnp.zeros((6,), jnp.float32)
    ssum = jnp.zeros((), jnp.float32)
    matched = jnp.zeros((n,), jnp.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = ((nx >= 0) & (nx < wx) & (ny >= 0) & (ny < wy)
                      & (nz >= 0) & (nz < wz))
                R = jnp.take(rows, jnp.clip((nx * wy + ny) * wz + nz, 0,
                                            g - 1), axis=0)
                l00, l01, l02 = R[:, 3], R[:, 4], R[:, 5]
                l11, l12, l22 = R[:, 6], R[:, 7], R[:, 8]
                ok = ok & (R[:, 9] > 0.5) & (w > 0.5)
                r = pts - R[:, 0:3]
                r0, r1, r2 = r[:, 0], r[:, 1], r[:, 2]
                q0 = l00 * r0 + l01 * r1 + l02 * r2
                q1 = l01 * r0 + l11 * r1 + l12 * r2
                q2 = l02 * r0 + l12 * r1 + l22 * r2
                d2 = q0 * r0 + q1 * r1 + q2 * r2
                gate = ok & (r0 * r0 + r1 * r1 + r2 * r2
                             < max_corr_dist ** 2)
                s = jnp.where(gate, jnp.exp(-jnp.minimum(
                    d2 / (2.0 * gamma), 30.0)), 0.0)
                lam = jnp.stack([jnp.stack([l00, l01, l02], -1),
                                 jnp.stack([l01, l11, l12], -1),
                                 jnp.stack([l02, l12, l22], -1)], -2)
                H += jnp.einsum("nia,n,nij,njb->ab", J, s, lam, J)
                b += jnp.einsum("nia,ni->a", J,
                                jnp.stack([s * q0, s * q1, s * q2], 1))
                ssum += jnp.sum(s)
                matched = jnp.maximum(matched, gate.astype(jnp.float32))
    return H, b, -ssum, jnp.sum(matched)


def test_compact_reference_equals_dense_reference():
    from tpu_slam.core.pointcloud import PointCloud
    from tpu_slam.ingest import synthetic as syn
    from tpu_slam.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam.mapping import voxel_map as jvm
    from tpu_slam.registration.ndt import NDTParams, ndt_field

    spec = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
    pts, valid = syn.simulate_vlp16_revolution(
        syn.default_office(), syn.se2_pose(0.0, 0.0, 0.0, z=1.2),
        n_azimuth=300, noise_std=0.01, rng=np.random.default_rng(0))
    cloud = PointCloud.from_points(jnp.asarray(pts[valid]), capacity=8192)
    vmap = jvm.insert_cloud(jvm.empty_map(16384), cloud, spec, 0.0)
    dims = (32, 32, 16)
    field = ndt_field(vmap, spec, NDTParams(window_dims=dims,
                                            terms_impl="pallas_interpret"))
    origin = jnp.asarray(spec.origin) + field.origin_cell * spec.leaf
    raster, _ = j_terms.build_terms_raster(cloud.points, cloud.mask,
                                           jnp.eye(4), origin, spec.leaf,
                                           dims, 4)
    T = jnp.eye(4).at[0, 3].set(0.05).at[1, 3].set(-0.03)
    ref = j_terms.ndt_terms_raster_reference(raster, field.planes, T, 4.0,
                                             1.0, dims, 4)
    got = compact_raster_reference(raster, field.planes, T, 4.0, 1.0, dims,
                                   4)
    for a, r in zip(got[:2], ref[:2]):
        a, r = np.asarray(a), np.asarray(r)
        assert np.abs(a - r).max() <= 1e-6 * np.abs(r).max()
    assert float(got[2]) == float(ref[2])
    assert float(got[3]) == float(ref[3]) > 1000


def _summary(poses, gt, records, builds, voxels, seconds):
    from tpu_slam_torch.pipeline.metrics import ate_rmse

    return dict(ate_m=ate_rmse(np.asarray(poses), gt, align=False),
                mean_matched_fraction=float(np.mean(
                    [r.matched_fraction for r in records])),
                mean_iterations=float(np.mean([r.iterations
                                               for r in records])),
                field_builds=builds, voxels=voxels, seconds=seconds)


def main(argv):
    import chip_smoke as cs
    from tpu_slam.core.pointcloud import PointCloud as JCloud
    from tpu_slam.pipeline.odometry import LidarOdometry as JOdometry

    j_terms.ndt_terms_raster = compact_raster_reference
    if "--cases" in argv:
        _cases()
    clouds, gt = cs.city_scans(cs.N_SCANS, "cpu")
    pts = [c.points.numpy() for c in clouds]
    masks = [c.mask.numpy() for c in clouds]
    jcfg = _reference_config(cs.config2())
    odo = JOdometry(jcfg)
    builds = []
    build = odo._build_fields
    odo._build_fields = lambda *a, **k: builds.append(1) or build(*a, **k)
    t0 = time.perf_counter()
    state = odo.init_state(jnp.asarray(gt[0], jnp.float32))
    poses = []
    for p, m in zip(pts, masks):
        state, _ = odo.step(state, JCloud(points=jnp.asarray(p),
                                          mask=jnp.asarray(m)))
        poses.append(np.asarray(state.pose))
    print(json.dumps(dict(engine="tpu_slam LidarOdometry, CPU", **_summary(
        poses, gt, odo.metrics.records, len(builds),
        int(state.vmap.n_occupied()), time.perf_counter() - t0))),
        flush=True)
    if "--port" in argv:
        from tpu_slam_torch.pipeline.odometry import LidarOdometry

        eng = LidarOdometry(cs.config2(), device="cpu")
        t0 = time.perf_counter()
        state = eng.init_state(gt[0])
        poses = []
        for c in clouds:
            state, _ = eng.step(state, c)
            poses.append(state.pose.numpy())
        print(json.dumps(dict(
            engine="tpu_slam_torch LidarOdometry, CPU", **_summary(
                poses, gt, eng.metrics.records, eng.field_builds,
                int(state.vmap.n_occupied()), time.perf_counter() - t0))),
            flush=True)


def _cases():
    """The reference's outdoor ring and pyramid on its kernel path, and
    icp_point on the office arc: one JSON line."""
    import dataclasses

    from tests import test_outdoor as to
    from tests import test_pipeline as tp
    from tpu_slam.core import se3
    from tpu_slam.pipeline.metrics import ate_rmse
    from tpu_slam.pipeline.odometry import LidarOdometry
    from tpu_slam.registration.icp import ICPParams
    from tpu_slam.registration.ndt import NDTParams

    def run(cfg, clouds, gt):
        odo = LidarOdometry(cfg)
        state = odo.init_state(jnp.asarray(gt[0], jnp.float32))
        poses, worst = [], 0.0
        for k, c in enumerate(clouds):
            state, _ = odo.step(state, c)
            poses.append(np.asarray(state.pose))
            xi = np.asarray(se3.log(jnp.asarray(
                np.linalg.inv(gt[k]) @ poses[-1], jnp.float32)))
            worst = max(worst, float(np.linalg.norm(xi[:3])))
        return worst, ate_rmse(np.stack(poses), gt, align=False)

    kernel = NDTParams(max_iterations=25, max_corr_dist=2.0,
                       terms_impl="pallas_interpret")
    world = to._city_world()
    out = {}
    clouds, gt = to._ring_sequence(world, n=25, step=0.5)
    out["ring_kernel_path"] = run(dataclasses.replace(
        to.OUTDOOR_CFG, ndt=kernel), clouds, gt)
    clouds, gt = to._ring_sequence(world, n=12, step=1.5)
    for pf in (0, 4):
        out[f"pyramid_{pf}_kernel_path"] = run(dataclasses.replace(
            to.OUTDOOR_CFG, ndt=kernel, pyramid_factor=pf), clouds, gt)
    clouds, gt = tp._sequence(n_poses=5)
    for method in ("icp_plane", "icp_point"):
        out[method] = run(dataclasses.replace(
            tp.ODOM_CFG, method=method,
            icp=ICPParams(max_iterations=25, max_corr_dist=1.0,
                          nn_impl="xla")), clouds, gt)
    print(json.dumps({k: dict(worst_m=w, ate_m=a)
                      for k, (w, a) in out.items()}), flush=True)


def _reference_config(cfg):
    """config2()'s OdometryConfig as the reference's, on its kernel path."""
    import dataclasses

    from tpu_slam.pipeline.config import OdometryConfig
    from tpu_slam.registration.icp import ICPParams
    from tpu_slam.registration.ndt import NDTParams

    d = dataclasses.asdict(cfg)
    ndt = dict(d.pop("ndt"), terms_impl="pallas_interpret")
    return OdometryConfig(ndt=NDTParams(**ndt), icp=ICPParams(**d.pop("icp")),
                          **d)


if __name__ == "__main__":
    main(sys.argv[1:])
