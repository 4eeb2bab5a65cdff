"""The sharded voxel map and NDT against it (tpu_slam_torch.distributed.
map_shard) against tpu_slam.distributed.map_shard, on the CPU.

The JAX side runs on the conftest's virtual CPU devices (``make_mesh(n)``)
with its raster terms kernel swapped for a test-local wrapper of
``ndt_terms_raster_reference`` that honours ``owned_planes`` (the oracle
of the kernel's own tests; the Pallas body itself runs in the reference's
tests); the port runs on n gloo ranks spawned once per rank count for the
whole module (``tests/test_torch_dist_ranks.py``). The same two office scans
(numpy, from the reference's simulator) go into both.

Tolerances: slab owners, keys, counts and stamps exact; the voxel moments
within 1e-5 of each array's largest magnitude (test_torch_voxel_insert's
bar); the kernel tier's pose within 1e-4 and score within 1e-3 of the
reference's sharded kernel tier (the reference's own bar against its
single device, tests/test_distributed.py), and within 1e-5 of the port's
single device; the fallback tier within 2e-4. The matched fraction is a
named divergence: the port counts a point on the rank that bins it (point
ownership), so its sharded count equals its single-device count exactly,
where the reference counts a point only when it is binned in the owning
device's planes, never more than the port (its seam bias).
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.distributed import map_shard as jms
from tpu_slam.distributed.mesh import make_mesh
from tpu_slam.ingest import synthetic as jsyn
from tpu_slam.kernels.voxel_hash import VoxelGridSpec as JSpec
from tpu_slam.registration.ndt import NDTParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import map_shard as ms
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY, VoxelGridSpec
from tpu_slam_torch.mapping.voxel_map import empty_map, insert_cloud
from tpu_slam_torch.registration.ndt import NDTParams, ndt_field, ndt_register

from tests import test_torch_dist_ranks as R

_REF_TERMS = j_terms.ndt_terms_raster_reference


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    """The reference's XLA twin of its raster kernel, with the kernel's
    ``owned_planes`` rule: matched counted over slots binned in x-planes
    [lo, hi) only (the raster's leading axis is x)."""
    H, b, cost, cnt = _REF_TERMS(raster, planes, T, gamma, max_corr_dist,
                                 dims, q_cap)
    if owned_planes is not None:
        lo, hi = owned_planes
        own = raster.at[:lo].set(0.0).at[hi:].set(0.0)
        cnt = _REF_TERMS(own, planes, T, gamma, max_corr_dist, dims,
                         q_cap)[3]
    return H, b, cost, cnt

SPEC = VoxelGridSpec.centered(leaf=0.5, half_extent=16.0)
JSPEC = JSpec.centered(leaf=0.5, half_extent=16.0)
CAP, SHARD_CAP = 8192, 4096
DIMS = (32, 32, 16)
XI = [0.2, -0.1, 0.08, 0.02, -0.03, 0.05]
MOMENT_RTOL = 1e-5
FIELDS = ms.MAP_FIELDS


def _scan(x0, n_azimuth=360):
    world = jsyn.default_office()
    T = np.eye(4)
    T[:3, 3] = [x0, 0.0, 1.5]
    pts, valid = jsyn.simulate_vlp16_revolution(world, T,
                                                n_azimuth=n_azimuth)
    return np.asarray(pts)[np.asarray(valid)].astype(np.float32)


def _params():
    kernel = dict(max_iterations=10, coarse_iterations=0, tolerance=3e-4,
                  min_voxel_count=3.0, raster_q=8, window_dims=DIMS)
    return (NDTParams(**kernel),
            JParams(**kernel, terms_impl="pallas_interpret"),
            NDTParams(max_iterations=30, terms_impl="xla"),
            JParams(max_iterations=30, pack_any_backend=False))


@pytest.fixture(scope="module")
def case():
    # two scans, the second 1.2 m along x at a later stamp: voxels merge
    # across inserts and the slab faces see both
    pts = [_scan(0.0), _scan(1.2)]
    stamps = [0.0, 1.0]
    T = np.asarray(jse3.exp(jnp.asarray(XI, jnp.float32)))
    src = ((pts[0] - T[:3, 3]) @ T[:3, :3]).astype(np.float32)
    pk, jpk, pf, jpf = _params()
    center = np.zeros(3, np.float32)
    cases = [("kernel", src, pk, center), ("fallback", src, pf, None)]
    # the port's ranks run in their own processes while the reference
    # compiles here
    pool = ThreadPoolExecutor(2)
    port = {2: pool.submit(M.run_ranks, R.map_body, 2, pts, CAP, SHARD_CAP,
                           SPEC, stamps, cases, device="cpu"),
            4: pool.submit(M.run_ranks, R.map_body, 4, pts, CAP, SHARD_CAP,
                           SPEC, stamps, cases[:1], device="cpu")}
    ref = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    jsrc = JCloud.from_points(jnp.asarray(src), capacity=CAP)
    for n in (2, 4):
        mesh = make_mesh(n)
        smap = jms.empty_sharded_map(n, SHARD_CAP)
        for p, st in zip(pts, stamps):
            smap = jms.insert_cloud_sharded(
                mesh, smap, JCloud.from_points(jnp.asarray(p), capacity=CAP),
                JSPEC, st)
        ref[n] = dict(smap=smap)
    # the registrations at two devices (each is a long XLA compile); the
    # port's four ranks are held to its single device exactly
    mesh = make_mesh(2)
    ref[2]["kernel"] = jms.ndt_register_sharded(
        mesh, jsrc, ref[2]["smap"], JSPEC, params=jpk, center=jnp.zeros(3))
    ref[2]["fallback"] = jms.ndt_register_sharded(
        mesh, jsrc, ref[2]["smap"], JSPEC, params=jpf)
    mp.undo()
    # the port's single-device registration on the whole map
    single = empty_map(2 * CAP, device="cpu")
    for p, st in zip(pts, stamps):
        single = insert_cloud(single, PointCloud.from_points_host(
            p, capacity=CAP, device="cpu"), SPEC, st)
    tsrc = PointCloud.from_points_host(src, capacity=CAP, device="cpu")
    one = ndt_register(tsrc, ndt_field(single, SPEC, pk,
                                       center=torch.zeros(3)),
                       SPEC, params=pk)
    port = {n: f.result() for n, f in port.items()}
    pool.shutdown()
    return dict(port=port, ref=ref, single=one, pts=pts, src=src)


def test_slab_owner_matches_reference_exactly():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-17, 17, (3000, 3)).astype(np.float32)
    from tpu_slam.kernels.voxel_hash import voxel_keys as jkeys
    from tpu_slam_torch.kernels.voxel_hash import voxel_keys

    jk = jkeys(JCloud.from_points(jnp.asarray(pts)), JSPEC)
    tk = voxel_keys(PointCloud.from_points_host(pts, capacity=3000,
                                                device="cpu"), SPEC)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tk == INVALID_KEY).any()          # out-of-grid points: owner -1
    for n in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(
            ms.slab_owner(tk, SPEC, n).numpy(),
            np.asarray(jms.slab_owner(jk, JSPEC, n)))


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_insert_matches_reference_stacked_map(case, n):
    ref = case["ref"][n]["smap"]
    for r, out in enumerate(case["port"][n]):
        got = out["stacked"]
        assert out["roundtrip_equal"]         # to_stacked -> from_stacked
        np.testing.assert_array_equal(out["local_keys"], got["keys"][r])
        for f in ("keys", "count", "stamp"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(ref, f)))
        for f in ("sum_pts", "sum_outer"):
            want = np.asarray(getattr(ref, f))
            np.testing.assert_allclose(
                got[f], want, rtol=0,
                atol=MOMENT_RTOL * max(float(np.abs(want).max()), 1e-12))
    # every voxel on its owner, and the slabs hold the single map's voxels
    keys = case["port"][n][0]["stacked"]["keys"]
    for d in range(n):
        k = keys[d][keys[d] != INVALID_KEY]
        assert (ms.slab_owner(torch.as_tensor(k), SPEC, n).numpy()
                == d).all()


def test_empty_sharded_map_matches_reference():
    ref = jms.empty_sharded_map(2, 16)
    stacked = {f: np.asarray(getattr(ref, f)) for f in FIELDS}
    # a rank's view needs no process group until a collective runs
    mesh = M.Mesh(None, 1, 2, "data", "gloo", torch.device("cpu"))
    sm = ms.from_stacked(mesh, stacked)
    empty = ms.empty_sharded_map(mesh, 16)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(sm.shard, f).numpy(),
                                      stacked[f][1])
        np.testing.assert_array_equal(getattr(empty.shard, f).numpy(),
                                      stacked[f][1])
    assert sm.local(1) is sm.shard and sm.shard_capacity == 16
    with pytest.raises(ValueError):
        sm.local(0)


@pytest.mark.parametrize("n", [2, 4])
def test_kernel_tier_matches_reference_and_single_device(case, n):
    port = [out["kernel"] for out in case["port"][n]]
    ref = case["ref"][2]["kernel"]
    one = case["single"]
    # lockstep: every rank ends with the same bits
    assert M.rank_results_equal([{k: p[k] for k in ("T", "score",
                                                    "matched")}
                                 for p in port])
    got = port[0]
    np.testing.assert_allclose(got["T"], np.asarray(ref.T), atol=1e-4)
    assert abs(float(got["score"]) - float(ref.score)) < 1e-3
    # the seam rule: exact against the port's single device, never below
    # the reference's sharded count
    assert float(got["matched"]) == float(one.matched_fraction)
    assert float(got["matched"]) >= float(ref.matched_fraction)
    np.testing.assert_allclose(got["T"], one.T.numpy(), atol=1e-5)
    assert got["iterations"] == one.iterations
    # collectives of a registration: one reduce-scatter and one halo
    # exchange for the field, one all-reduce an evaluation
    assert got["calls"]["reduce_scatter"] == 1
    assert got["calls"]["halo_exchange"] == 1
    assert got["calls"]["all_reduce"] >= got["iterations"]


def test_fallback_tier_matches_reference(case):
    got = case["port"][2][0]["fallback"]
    ref = case["ref"][2]["fallback"]
    np.testing.assert_allclose(got["T"], np.asarray(ref.T), atol=2e-4)
    assert abs(float(got["matched"]) - float(ref.matched_fraction)) < 1e-6
    assert got["calls"].get("reduce_scatter", 0) == 0
