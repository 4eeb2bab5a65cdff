"""The port's copies of the replay stack against the originals (CPU):
VLP-16 packets and pcap (``ingest.velodyne``), the rosbag writer and
reader (``ingest.rosbag``), the npz dataset (``ingest.dataset``), the
synthetic range image and pcap capture (``ingest.synthetic``), and the
quaternion helpers of ``core.se3``.

Bench config 6's conversion runs on both sides from the same inputs:
packets -> pcap -> revolutions -> bag with TF ground truth -> dataset. The
pcap and bag files are byte-equal, the dataset's index byte-equal and its
scans' arrays byte-equal (the npz members; the zip container stamps its
own write time). Quaternions: within 1e-6 of the reference (each
component; the bag test feeds both writers the same quaternions).
"""

import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.ingest import dataset as jds
from tpu_slam.ingest import rosbag as jrb
from tpu_slam.ingest import synthetic as jsyn
from tpu_slam.ingest import velodyne as jvlp
from tpu_slam_torch.core import se3
from tpu_slam_torch.ingest import dataset as ds
from tpu_slam_torch.ingest import rosbag as rb
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.ingest import velodyne as vlp


def _poses():
    return [syn.se2_pose(0.2 * k - 0.3, 0.05 * k, 0.04 * k, z=1.2)
            for k in range(4)]


def _packets(world, poses, n_az=360, seed=0):
    """bench_bag_replay's packet synthesis at a small size."""
    el = np.radians(vlp.VLP16_ELEVATIONS_DEG)
    az = np.arange(n_az) * (360.0 / n_az)
    az_r = np.radians(az)[:, None]
    dirs = np.stack([np.cos(el)[None, :] * np.cos(az_r),
                     np.cos(el)[None, :] * np.sin(az_r),
                     np.broadcast_to(np.sin(el)[None, :], (n_az, 16))],
                    axis=2)
    rng = np.random.default_rng(seed)
    pkts, times = [], []
    for k, T in enumerate(poses):
        dirs_w = dirs.reshape(-1, 3) @ T[:3, :3].T
        r = world.raycast(np.broadcast_to(T[:3, 3], dirs_w.shape), dirs_w,
                          40.0).reshape(n_az, 16)
        r = np.where(np.isfinite(r), r + rng.normal(0, 0.01, r.shape), 0.0)
        p = vlp.encode_packets(az, r, start_time_s=100.0 + k)
        pkts.append(p)
        times.append(100.0 + k + np.arange(p.shape[0]) * 1e-3)
    return np.concatenate(pkts), np.concatenate(times)


def _convert(vlp_mod, rb_mod, ds_mod, pkts, times, poses, quats, tmp):
    """pcap -> revolutions -> bag (clouds + TF) -> dataset, with one
    package's modules; returns the three paths and the revolutions."""
    os.makedirs(tmp, exist_ok=True)
    pcap = vlp_mod.write_pcap(os.path.join(tmp, "seq.pcap"), pkts,
                              timestamps_s=times)
    stream = vlp_mod.VelodyneStream(min_range=0.4, max_range=40.0)
    revs = []
    for _ts, payload in vlp_mod.read_pcap(pcap):
        stream.push(np.frombuffer(payload, np.uint8)[None])
        while (rev := stream.pop()) is not None:
            revs.append(rev)
    if (rev := stream.flush()) is not None:
        revs.append(rev)
    revs = revs[:len(poses)]
    bag = os.path.join(tmp, "seq.bag")
    with rb_mod.BagWriter(bag) as w:
        for k, (rev, T, q) in enumerate(zip(revs, poses, quats)):
            t = 100.0 + k
            tf = rb_mod.TransformStamped(
                stamp=t - 0.01, frame_id="odom", child_frame_id="velodyne",
                translation=T[:3, 3].copy(), rotation=q.astype(np.float64))
            w.write("/tf", "tf2_msgs/TFMessage",
                    rb_mod.serialize_tf_message([tf]), t - 0.01)
            w.write("/velodyne_points", "sensor_msgs/PointCloud2",
                    rb_mod.serialize_pointcloud2(rev.points, t, "velodyne"),
                    t)
    root = rb_mod.bag_to_dataset(bag, bag + ".dataset", gt_frame="odom")
    return pcap, bag, root, revs


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("replay")
    poses = _poses()
    pkts, times = _packets(syn.default_office(), poses)
    jpkts, _ = _packets(jsyn.default_office(), poses)
    assert np.array_equal(pkts, jpkts)
    quats = [np.asarray(jse3.quat_from_matrix(jnp.asarray(T[:3, :3],
                                                          jnp.float32)))
             for T in poses]
    out = {}
    for name, mods in (("port", (vlp, rb, ds)), ("ref", (jvlp, jrb, jds))):
        out[name] = _convert(*mods, pkts, times, poses, quats,
                             str(tmp / name))
    return out, poses


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_pcap_and_bag_bytes_equal(converted):
    out, poses = converted
    (pcap, bag, _, revs), (jpcap, jbag, _, jrevs) = out["port"], out["ref"]
    assert _bytes(pcap) == _bytes(jpcap)
    assert _bytes(bag) == _bytes(jbag)
    assert len(revs) == len(jrevs) == len(poses)
    for a, b in zip(revs, jrevs):
        for k in ("points", "intensity", "ring", "time_s"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
        assert a.stamp == b.stamp
    # the reader decodes what the writer wrote, on both sides
    with rb.BagReader(bag) as r, jrb.BagReader(jbag) as jr:
        msgs, jmsgs = list(r), list(jr)
        assert r.topics() == jr.topics()
    assert [(m.topic, m.msg_type, m.raw) for m in msgs] == [
        (m.topic, m.msg_type, m.raw) for m in jmsgs]
    pc = rb.parse_pointcloud2(msgs[1].raw)
    np.testing.assert_array_equal(pc.xyz()[0], revs[0].points)


def test_dataset_files_equal(converted):
    out, poses = converted
    root, jroot = out["port"][2], out["ref"][2]
    assert _bytes(os.path.join(root, "index.json")) == _bytes(
        os.path.join(jroot, "index.json"))
    names = sorted(os.listdir(os.path.join(root, "scans")))
    assert names == sorted(os.listdir(os.path.join(jroot, "scans")))
    assert len(names) == len(poses)
    for n in names:
        with zipfile.ZipFile(os.path.join(root, "scans", n)) as a, \
                zipfile.ZipFile(os.path.join(jroot, "scans", n)) as b:
            assert a.namelist() == b.namelist()
            for member in a.namelist():
                assert a.read(member) == b.read(member), (n, member)
    reader, jreader = ds.DatasetReader(root), jds.DatasetReader(jroot)
    assert len(reader) == len(jreader) == len(poses)
    np.testing.assert_array_equal(reader.gt_poses(), jreader.gt_poses())
    for a, b in zip(reader, jreader):
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.mask, b.mask)
        assert (a.stamp, a.frame_id) == (b.stamp, b.frame_id)
    # the TF ground truth is the route, to the quaternions' float32
    np.testing.assert_allclose(reader.gt_poses(), np.stack(poses),
                               atol=1e-6)


def test_synthesized_pcap_and_range_image_equal(tmp_path):
    world, jworld = syn.default_office(), jsyn.default_office()
    traj = np.stack(_poses()[:2])
    az, r = syn.simulate_vlp16_range_image(
        world, traj[0], n_azimuth=240, noise_std=0.01,
        rng=np.random.default_rng(3))
    jaz, jr = jsyn.simulate_vlp16_range_image(
        jworld, traj[0], n_azimuth=240, noise_std=0.01,
        rng=np.random.default_rng(3))
    np.testing.assert_array_equal(az, jaz)
    np.testing.assert_array_equal(r, jr)
    assert r.shape == (240, 16) and (r > 0).mean() > 0.5
    a = syn.synthesize_vlp16_pcap(str(tmp_path / "a.pcap"), world, traj,
                                  n_azimuth=240, noise_std=0.01,
                                  rng=np.random.default_rng(4))
    b = jsyn.synthesize_vlp16_pcap(str(tmp_path / "b.pcap"), jworld, traj,
                                   n_azimuth=240, noise_std=0.01,
                                   rng=np.random.default_rng(4))
    assert _bytes(a) == _bytes(b)
    n = sum(1 for _ in vlp.read_pcap(a))
    assert n == sum(1 for _ in jvlp.read_pcap(b)) > 0


def _rotations(n=64, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1.5, (n, 3)).astype(np.float32)
    # the four Shepperd cases: near identity and near pi about each axis
    w[:4] = [[1e-4, 0, 0], [3.1, 0.01, 0], [0, 3.1, 0.02], [0.01, 0, 3.1]]
    return np.asarray(jax.vmap(jse3.so3_exp)(jnp.asarray(w)))


def test_quaternion_helpers_match_reference():
    R = _rotations()
    ref_q = np.asarray(jax.vmap(jse3.quat_from_matrix)(jnp.asarray(R)))
    q = se3.quat_from_matrix(torch.tensor(R))
    assert q.shape == (len(R), 4)
    np.testing.assert_allclose(q.numpy(), ref_q, atol=1e-6)
    one = se3.quat_from_matrix(torch.tensor(R[1]))
    assert one.shape == (4,)
    np.testing.assert_allclose(one.numpy(), ref_q[1], atol=1e-6)
    ref_R = np.asarray(jax.vmap(jse3.quat_to_matrix)(jnp.asarray(ref_q)))
    np.testing.assert_allclose(se3.quat_to_matrix(torch.tensor(ref_q))
                               .numpy(), ref_R, atol=1e-6)
    np.testing.assert_allclose(ref_R, R, atol=1e-5)          # round trip
    ang = se3.quat_angle_between(torch.tensor(ref_q[:-1]),
                                 torch.tensor(ref_q[1:]))
    ref_ang = np.asarray(jax.vmap(jse3.quat_angle_between)(
        jnp.asarray(ref_q[:-1]), jnp.asarray(ref_q[1:])))
    np.testing.assert_allclose(ang.numpy(), ref_ang, atol=1e-5)
    rpy = np.random.default_rng(1).uniform(-3, 3, (16, 3)).astype(np.float32)
    got = se3.quat_from_euler(*torch.tensor(rpy).unbind(1))
    ref = np.asarray(jax.vmap(jse3.quat_from_euler)(
        *jnp.asarray(rpy).T))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-6)
