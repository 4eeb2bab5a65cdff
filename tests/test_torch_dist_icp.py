"""Data-parallel pair ICP (tpu_slam_torch.distributed.registration_dist)
against tpu_slam.distributed.registration_dist, on the CPU.

Ten pairs of the reference test's three-plane scene (numpy seed), a batch
that two and four ranks do not divide, so the padding path runs. The
reference runs on the conftest's virtual CPU devices, the port on gloo
ranks (one spawn per rank count).

Tolerances: the padded batch exact (coordinates, masks, identity inits);
each pair's T within 1e-5 of the reference's sharded result and of the
port's own batched ``icp`` on the whole batch, iterations and converged
equal, every rank's result bit-identical.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.core import se3 as jse3
from tpu_slam.core.pointcloud import PAD_COORD
from tpu_slam.distributed.mesh import make_mesh
from tpu_slam.distributed.registration_dist import pad_batch as j_pad_batch
from tpu_slam.distributed.registration_dist import \
    sharded_pairwise_icp as j_sharded
from tpu_slam.registration.icp import ICPParams as JParams
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.distributed.registration_dist import pad_batch
from tpu_slam_torch.registration.icp import ICPParams, icp

from tests import test_torch_dist_ranks as R
from tests.test_distributed import _scene

B, P = 10, 512
KW = dict(max_iterations=30, max_corr_dist=2.0)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(0)
    sp = np.full((B, P, 3), PAD_COORD, np.float32)
    sm = np.zeros((B, P), bool)
    tp = np.full((B, P, 3), PAD_COORD, np.float32)
    tm = np.zeros((B, P), bool)
    for k in range(B):
        tgt = _scene(rng)
        T = np.asarray(jse3.exp(jnp.asarray(rng.normal(0, 0.08, 6)
                                            .astype(np.float32))))
        tp[k, :400], tm[k, :400] = tgt, True
        sp[k, :400], sm[k, :400] = (tgt - T[:3, 3]) @ T[:3, :3], True
    init = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    args = (sp, sm, tp, tm, init, ICPParams(**KW))
    pool = ThreadPoolExecutor(2)
    port = {n: pool.submit(M.run_ranks, R.icp_body, n, *args,
                             device="cpu")
            for n in (2, 4)}
    jargs = tuple(jnp.asarray(a) for a in (sp, sm, tp, tm, init))
    ref = {n: j_sharded(make_mesh(n), *jargs,
                        params=JParams(**KW, nn_impl="xla"))
           for n in (2, 4)}
    one = icp(PointCloud(points=torch.as_tensor(sp),
                         mask=torch.as_tensor(sm)),
              PointCloud(points=torch.as_tensor(tp),
                         mask=torch.as_tensor(tm)),
              init_T=torch.as_tensor(init), params=ICPParams(**KW))
    port = {n: f.result() for n, f in port.items()}
    pool.shutdown()
    return dict(port=port, ref=ref, one=one, args=args)


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_pairwise_icp_matches_reference(case, n):
    ranks = case["port"][n]
    assert M.rank_results_equal(ranks)
    got, ref, one = ranks[0], case["ref"][n], case["one"]
    assert got["T"].shape == (B, 4, 4)
    np.testing.assert_allclose(got["T"], np.asarray(ref.T), atol=1e-5)
    np.testing.assert_array_equal(got["iterations"],
                                  np.asarray(ref.iterations))
    np.testing.assert_array_equal(got["converged"],
                                  np.asarray(ref.converged))
    # the shards are the whole batch's own solves
    np.testing.assert_allclose(got["T"], one.T.numpy(), atol=1e-5)
    np.testing.assert_array_equal(got["iterations"], one.iterations.numpy())
    np.testing.assert_allclose(got["matched_fraction"],
                               one.matched_fraction.numpy(), atol=1e-6)


@pytest.mark.parametrize("multiple", [1, 3, 4, 8])
def test_pad_batch_matches_reference(case, multiple):
    sp, sm = case["args"][0], case["args"][1]
    for x, fill in ((sp, PAD_COORD), (sm, False), (sp[:, 0], 0.0)):
        got = pad_batch(torch.as_tensor(x), multiple, fill)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(j_pad_batch(jnp.asarray(x), multiple,
                                                fill)))
