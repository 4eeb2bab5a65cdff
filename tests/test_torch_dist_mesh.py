"""The distributed layer's collectives, bring-up and heartbeat
(tpu_slam_torch.distributed.mesh, .multihost) against tpu_slam.
distributed's, on the CPU.

The collectives run on 2 and 4 gloo ranks and their JAX counterparts
(psum, psum_scatter, all_gather, ppermute) under shard_map on the
conftest's virtual CPU devices, on integer-valued float32 data, so the
results are compared bit for bit. ``multihost.initialize`` joins two
processes from the environment alone (a case the reference never had: its
initialize was only ever called without a cluster).
"""

import functools
import multiprocessing
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpu_slam.distributed import multihost as jmultihost
from tpu_slam.distributed.mesh import make_mesh
from tpu_slam_torch.distributed import mesh as M
from tpu_slam_torch.distributed import multihost

from tests import test_torch_dist_ranks as R

ROWS = 8


def _per_rank(n):
    rng = np.random.default_rng(n)
    return rng.integers(-1000, 1000, (n, ROWS, 3)).astype(np.float32)


def _reference(n, x):
    """The reference's collectives on the same per-device rows."""
    mesh = make_mesh(n)
    body = functools.partial(jax.shard_map, mesh=mesh, check_vma=False,
                             in_specs=P("data"), out_specs=P("data"))

    @body
    def run(xl):
        a = xl[0]
        up = jax.lax.ppermute(a, "data", [(i, i + 1) for i in range(n - 1)])
        down = jax.lax.ppermute(a, "data",
                                [(i + 1, i) for i in range(n - 1)])
        return (jax.lax.psum(a, "data")[None],
                jax.lax.psum_scatter(a, "data", scatter_dimension=0,
                                     tiled=True)[None],
                jax.lax.all_gather(a, "data", tiled=True)[None],
                up[None], down[None])

    names = ("all_reduce", "reduce_scatter", "all_gather", "shift_up",
             "shift_down")
    return dict(zip(names, (np.asarray(o) for o in run(jnp.asarray(x)))))


@pytest.fixture(scope="module")
def ranks():
    return {n: M.run_ranks(R.collectives_body, n, _per_rank(n),
                              device="cpu")
            for n in (2, 4)}


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_reference_bit_for_bit(ranks, n):
    x = _per_rank(n)
    ref = _reference(n, x)
    for r, got in enumerate(ranks[n]):
        for name, want in ref.items():
            np.testing.assert_array_equal(got[name], want[r], err_msg=name)
        # the halo exchange is both shifts of the edge rows in one batch
        np.testing.assert_array_equal(got["halo_left"],
                                      ref["shift_up"][r][-2:])
        np.testing.assert_array_equal(got["halo_right"],
                                      ref["shift_down"][r][:2])
        assert got["calls"] == dict(halo_exchange=1, all_reduce=1,
                                    reduce_scatter=1, all_gather=1, shift=2)


def test_ranks_default_to_the_card(monkeypatch):
    """Without ``device`` the ranks run on CUDA: with no card the spawn
    helper raises before it starts a rank, never falling back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        M.run_ranks(R.collectives_body, 2, _per_rank(2))


def test_reduce_scatter_rejects_an_indivisible_axis():
    mesh = M.Mesh(None, 0, 3, "data", "gloo", torch.device("cpu"))
    with pytest.raises(ValueError, match="not divisible"):
        M.reduce_scatter(mesh, torch.zeros(4))
    with pytest.raises(ValueError, match="step"):
        M.shift(mesh, torch.zeros(4), 2)


def test_mesh_2d_and_heartbeat_on_four_ranks():
    """A (2, 2) layout's two axes, then the heartbeat: healthy True; a
    hung probe (a dead peer) False within its timeout; a raising probe (a
    torn-down group) False — tests/test_distributed.py's bars."""
    grid = M.run_ranks(R.mesh2d_body, 4, device="cpu")
    for r, got in enumerate(grid):
        i, j = divmod(r, 2)
        assert (got["data_rank"], got["graph_rank"]) == (i, j)
        assert float(got["graph"][0]) == 2 * i + (2 * i + 1)
        assert float(got["data"][0]) == j + (2 + j)
        assert float(got["graph_up"][0]) == (0.0 if j == 0 else 10.0 + r - 1)
    for got in M.run_ranks(R.heartbeat_body, 4, device="cpu"):
        assert got["healthy"] is True
        assert got["hung"] is False and got["hung_s"] < 5.0
        assert got["raised"] is False


def test_initialize_from_the_environment_on_two_processes():
    """Two bare processes, each given only the reference's variables (a
    file:// init method), join one group through multihost.initialize."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "init")
        envs = [dict(JAX_COORDINATOR_ADDRESS=f"file://{path}",
                     JAX_NUM_PROCESSES="2", JAX_PROCESS_ID=str(r))
                for r in range(2)]
        pool = multiprocessing.get_context("spawn").Pool(2)
        try:
            outs = pool.map_async(R.initialize_body, envs,
                                  chunksize=1).get(timeout=300)
        finally:
            pool.terminate()
            pool.join()
    for r, got in enumerate(outs):
        assert got["active"] is True
        assert got["before"] == (0, 1)          # no group yet
        assert (got["index"], got["count"]) == (r, 2)
        assert got["coordinator"] is (r == 0)
        assert got["backend"] == "gloo"
        assert float(got["total"][0]) == 3.0


def test_single_process_answers_as_the_reference(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is jmultihost.initialize() is False
    assert multihost.initialize("localhost:1", num_processes=1) is False
    assert (multihost.process_index(), multihost.process_count(),
            multihost.is_coordinator()) == (
        jmultihost.process_index(), jmultihost.process_count(),
        jmultihost.is_coordinator())


def test_heartbeat_seam_without_a_group():
    """The fault seam alone, as the reference's test drives it: no
    collective runs, so no process group is needed."""
    mesh = M.Mesh(None, 0, 1, "data", "gloo", torch.device("cpu"))
    seen = []
    assert multihost.heartbeat(mesh, _probe_fn=seen.append) is True
    assert seen[0].shape == (1,)
    t0 = time.monotonic()
    assert multihost.heartbeat(mesh, timeout_s=0.3,
                               _probe_fn=lambda x: time.sleep(30)) is False
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(ValueError, match="axis"):
        multihost.heartbeat(mesh, axis_name="graph")
