"""The port's sparse NDT path and cube window against tpu_slam's (CPU).

Held against the reference on the same seeded map and scan:
``neighbor_offsets_keys`` (exact), the closed-form 3x3 helpers of
``core.sym3``, the sparse field (``ndt_field`` with ``terms_impl="xla"``:
keys and valid flags exact, means within 1e-5 m, information within 1e-4
of each matrix's largest entry), ``_ndt_correspond`` and ``_ndt_terms``
(isotropic too) on the reference's own field (slots, hits and matched
fractions exact; the best Gaussian the same but at near-ties of d2; H, b
and cost within 1e-5 of each block's largest magnitude, of its sum of
absolute terms where the block cancels), and
``ndt_register`` end to end on both paths (poses within 1e-4 m / 1e-4
rad, iterations exact).

Named divergence: the port's ``terms_impl="auto"`` takes the kernel path
(the dense field window and the terms kernel) on every device, where the
reference's "auto" takes it only on its accelerator and the sparse path on
a CPU. Every comparison here pins the path on both sides: the port's
"xla" against the reference's "xla", the port's "auto" against the
reference's "pallas_interpret" with its terms kernel swapped for
``ndt_terms_raster_reference``.

The reference's CPU field carries a dense cell-to-slot table and packed
rows, so its ``_ndt_terms`` sums the same terms lane-wise in another
layout; the port finds the same slots by binary search and sums by
einsum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_slam.kernels.ndt_terms as j_terms
from tpu_slam.core import se3 as jse3
from tpu_slam.core import sym3 as jsym3
from tpu_slam.core.pointcloud import PointCloud as JCloud
from tpu_slam.kernels import voxel_hash as jvh
from tpu_slam.mapping import voxel_map as jvm
from tpu_slam.registration import ndt as jndt
from tpu_slam_torch.core import se3
from tpu_slam_torch.core import sym3
from tpu_slam_torch.core.pointcloud import PointCloud
from tpu_slam_torch.ingest import synthetic as syn
from tpu_slam_torch.kernels import voxel_hash as vh
from tpu_slam_torch.mapping import voxel_map as vm
from tpu_slam_torch.registration import ndt

LEAF, HALF = 0.5, 16.0
SPEC = vh.VoxelGridSpec.centered(leaf=LEAF, half_extent=HALF)
JSPEC = jvh.VoxelGridSpec.centered(leaf=LEAF, half_extent=HALF)
# a 32-cell grid: the cube window of window_bits 4 (16 cells a side) sits
# inside it around the scan
CUBE_SPEC = vh.VoxelGridSpec.centered(leaf=1.0, half_extent=HALF)
CUBE_JSPEC = jvh.VoxelGridSpec.centered(leaf=1.0, half_extent=HALF)


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _reference_terms(raster, planes, T, gamma, max_corr_dist, dims, q_cap,
                     interpret=False, owned_planes=None, plane_flags=None):
    return j_terms.ndt_terms_raster_reference(raster, planes, T, gamma,
                                              max_corr_dist, dims, q_cap)


@pytest.fixture(scope="module")
def case():
    """A map of two office scans (the reference's insert), a third scan
    and a perturbed init."""
    world = syn.default_office()
    rng = np.random.default_rng(0)
    poses = [syn.se2_pose(-0.5, -0.2, 0.0, z=1.2),
             syn.se2_pose(0.6, 0.3, 0.25, z=1.2),
             syn.se2_pose(0.1, 0.0, 0.1, z=1.2)]
    scans = []
    for T in poses:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=300, noise_std=0.005, rng=rng)
        scans.append(pts[valid])
    maps = {}
    for key, jspec in (("fine", JSPEC), ("cube", CUBE_JSPEC)):
        jmap = jvm.empty_map(16384)
        for T, p in zip(poses[:2], scans[:2]):
            w = (p @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
            jmap = jvm.insert_cloud(jmap, JCloud.from_points(
                jnp.asarray(w), capacity=8192), jspec, stamp=0.0)
        maps[key] = (jmap, vm.voxel_map_from_numpy(
            *(np.asarray(getattr(jmap, f)) for f in
              ("keys", "count", "sum_pts", "sum_outer", "stamp")),
            device="cpu"))
    T_true = poses[2].astype(np.float32)
    err = np.asarray(jse3.exp(jnp.asarray(np.array(
        [0.12, -0.08, 0.03, 0.0, 0.01, 0.04], np.float32))))
    init = (err @ T_true).astype(np.float32)
    src = scans[2][::2]
    return dict(maps=maps, src=src, init=init, T_true=T_true)


def _src(case):
    return (JCloud.from_points(jnp.asarray(case["src"]), capacity=4096),
            PointCloud.from_points_host(case["src"], capacity=4096,
                                        device="cpu"))


def _assert_blocks(got, ref, abs_scale=None, rtol=1e-5):
    """H (6, 6) in 3x3 blocks, b in halves, cost: each within rtol of the
    part's largest magnitude, or of its sum of absolute terms where
    given."""
    H, b, cost = (np.asarray(x, np.float64) for x in got[:3])
    rH, rb, rc = (np.asarray(x, np.float64) for x in ref[:3])
    for i in (0, 3):
        for j in (0, 3):
            blk, rblk = H[i:i + 3, j:j + 3], rH[i:i + 3, j:j + 3]
            scale = np.abs(rblk).max()
            if abs_scale is not None:
                scale = max(scale, abs_scale[0][i:i + 3, j:j + 3].max())
            assert np.abs(blk - rblk).max() <= rtol * scale, (i, j)
        half, rhalf = b[i:i + 3], rb[i:i + 3]
        scale = np.abs(rhalf).max()
        if abs_scale is not None:
            scale = max(scale, abs_scale[1][i:i + 3].max())
        assert np.abs(half - rhalf).max() <= rtol * scale, i
    assert abs(cost - rc) <= rtol * abs(rc)


def test_neighbor_offsets_keys_matches_reference():
    rng = np.random.default_rng(1)
    n = SPEC.cells_per_axis
    cells = rng.integers(0, n, (400, 3)).astype(np.int32)
    cells[:6] = [[0, 0, 0], [n - 1, n - 1, n - 1], [0, n - 1, 5],
                 [n - 1, 0, 0], [3, 0, n - 1], [1, 1, 1]]
    keys = np.array(jvh.pack_key(jnp.asarray(cells), JSPEC))
    keys[-3:] = jvh.INVALID_KEY
    got = vh.neighbor_offsets_keys(torch.as_tensor(keys), SPEC).numpy()
    ref = np.asarray(jvh.neighbor_offsets_keys(jnp.asarray(keys), JSPEC))
    np.testing.assert_array_equal(got, ref)
    # (dx, dy, dz) order, dz fastest: neighbour 1 is (-1, -1, 0)
    b = SPEC.dim_bits
    c = cells[5]
    assert got[5, 1] == ((c[0] - 1) << 2 * b) | ((c[1] - 1) << b) | c[2]


def test_sym3_helpers_match_reference():
    rng = np.random.default_rng(2)
    a = rng.normal(size=(500, 3, 3)).astype(np.float32)
    cov = (a @ a.transpose(0, 2, 1) * 0.01
           + np.eye(3, dtype=np.float32) * 1e-4).astype(np.float32)
    cov[:50, 2] *= 1e-3                        # thin, planar ones
    cov[:50, :, 2] *= 1e-3
    tc, jc = torch.as_tensor(cov), jnp.asarray(cov)
    for name in ("eigvals_sym3", "inv_sym3"):
        got = getattr(sym3, name)(tc).numpy()
        ref = np.asarray(getattr(jsym3, name)(jc))
        scale = np.abs(ref).reshape(len(ref), -1).max(axis=1)
        err = np.abs(got - ref).reshape(len(ref), -1).max(axis=1)
        assert np.all(err <= 1e-5 * scale), name
    got = sym3.floored_info_sym3(tc, 0.01).numpy()
    ref = np.asarray(jsym3.floored_info_sym3(jc, 0.01))
    scale = np.abs(ref).reshape(len(ref), -1).max(axis=1)
    assert np.all(np.abs(got - ref).reshape(len(ref), -1).max(axis=1)
                  <= 1e-5 * scale)
    for i in range(3):
        assert np.array_equal(sym3._tri6_of(tc)[i].numpy(),
                              np.asarray(jsym3._tri6_of(jc)[i]))


@pytest.mark.parametrize("use_neighborhood", [True, False])
def test_sparse_field_matches_reference(case, use_neighborhood):
    jmap, tmap = case["maps"]["fine"]
    kw = dict(use_neighborhood=use_neighborhood, min_voxel_count=3.0)
    jf = jndt.ndt_field(jmap, JSPEC, jndt.NDTParams(terms_impl="xla", **kw))
    tf = ndt.ndt_field(tmap, SPEC, ndt.NDTParams(terms_impl="xla", **kw))
    assert tf.rows is None and jf.planes is None
    np.testing.assert_array_equal(tf.keys.numpy(), np.asarray(jf.keys))
    np.testing.assert_array_equal(tf.valid.numpy(), np.asarray(jf.valid))
    v = tf.valid.numpy()
    assert v.sum() > 200
    np.testing.assert_allclose(tf.means.numpy()[v],
                               np.asarray(jf.means)[v], rtol=0, atol=1e-5)
    ri = np.asarray(jf.info)[v]
    scale = np.abs(ri).reshape(len(ri), -1).max(axis=1)
    err = np.abs(tf.info.numpy()[v] - ri).reshape(len(ri), -1).max(axis=1)
    assert np.all(err <= 1e-4 * scale)


def _port_field_of(jf):
    """The reference's sparse field, as the port's field: the terms are
    compared on identical Gaussians."""
    def t(x):
        return torch.as_tensor(np.array(x))
    return ndt.NDTField(keys=t(jf.keys), means=t(jf.means),
                        info=t(jf.info), valid=t(jf.valid))


def test_correspond_matches_reference(case):
    jmap, _ = case["maps"]["fine"]
    jf = jndt.ndt_field(jmap, JSPEC, jndt.NDTParams(terms_impl="xla"))
    tf = _port_field_of(jf)
    T = case["init"]
    pts = (case["src"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    jmu, jlam, jmatched, jd2 = jndt._ndt_correspond(jnp.asarray(pts), jf,
                                                    JSPEC)
    mu, lam, matched, d2 = ndt._ndt_correspond(torch.as_tensor(pts), tf,
                                               SPEC)
    np.testing.assert_array_equal(matched.numpy(), np.asarray(jmatched))
    m = matched.numpy()
    assert m.mean() > 0.5
    # the chosen Gaussian: adjacent voxels' neighbourhood Gaussians are
    # nearly equal, so where two of them tie in d2 to float rounding the
    # einsum order may pick the other one. Outside such near-ties (at
    # most 1 % of the points) means agree within 1e-6 m and information
    # within 1e-6 relative; at them the two picks' d2 agree within 1e-5.
    same = (np.abs(mu.numpy() - np.asarray(jmu)).max(1) <= 1e-6) & (
        np.abs(lam.numpy() - np.asarray(jlam)).reshape(-1, 9).max(1)
        <= 1e-6 * np.abs(np.asarray(jlam)).reshape(-1, 9).max(1))
    tie = m & ~same
    assert tie.sum() <= 0.01 * m.sum()
    np.testing.assert_allclose(d2.numpy()[tie], np.asarray(jd2)[tie],
                               rtol=1e-5)
    # the slots and hits under the correspondences, exact
    nkeys = vh.neighbor_offsets_keys(vh.pack_key(vh.cell_coords(
        torch.as_tensor(pts), SPEC), SPEC), SPEC)
    pos, hit = ndt._probe_slots(tf, nkeys)
    jpos, jhit = jndt._probe_slots(
        jndt.NDTField(keys=jf.keys, means=jf.means, info=jf.info,
                      valid=jf.valid), jnp.asarray(nkeys.numpy()))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(pos.numpy()[hit.numpy()],
                                  np.asarray(jpos)[hit.numpy()])


def _abs_terms(pts_src, T, field, params, gamma, isotropic):
    """Each block's sum of absolute terms (the scale of a block whose
    terms cancel), from the port's per-point pieces."""
    pts = se3.apply(torch.as_tensor(T), torch.as_tensor(pts_src))
    pos, ok = ndt._neighbour_slots(pts, field, SPEC)
    r = pts[:, None, :] - field.means[pos]
    lams = field.info[pos]
    if isotropic:
        sig2 = (0.5 * params.max_corr_dist) ** 2
        lams = (torch.eye(3) / sig2).expand(lams.shape)
        s = torch.exp(-0.5 * (r * r).sum(-1) / (sig2 * gamma))
    else:
        d2 = torch.einsum("nki,nkij,nkj->nk", r, lams, r)
        s = torch.exp(-0.5 * torch.clamp(d2 / gamma, max=30.0))
    s = torch.where(ok & ((r * r).sum(-1) < params.max_corr_dist ** 2),
                    s, 0.0)
    J = torch.cat([torch.eye(3).expand(len(pts), 3, 3), -se3.hat(pts)], 2)
    JL = torch.einsum("nia,nkij->nkaj", J, lams)
    Habs = torch.einsum("nk,nkaj,njb->ab", s, JL.abs(), J.abs())
    babs = torch.einsum("nk,nkaj,nkj->a", s, JL.abs(), r.abs())
    return Habs.double().numpy(), babs.double().numpy()


@pytest.mark.parametrize("isotropic", [False, True])
def test_ndt_terms_match_reference(case, isotropic):
    jmap, _ = case["maps"]["fine"]
    params = ndt.NDTParams(terms_impl="xla")
    jf = jndt.ndt_field(jmap, JSPEC, jndt.NDTParams(terms_impl="xla"))
    tf = _port_field_of(jf)
    jsrc, tsrc = _src(case)
    T = case["init"]
    gamma = 4.0 * 16.0 if not isotropic else 4.0
    ref = jndt._ndt_terms(jsrc, jnp.asarray(T), jf, JSPEC,
                          jndt.NDTParams(terms_impl="xla"),
                          jnp.float32(gamma), isotropic)
    got = ndt._ndt_terms(tsrc, torch.as_tensor(T), tf, SPEC, params, gamma,
                         isotropic)
    assert float(got[3]) == float(ref[3]) > 0.5       # matched fraction
    _assert_blocks(got, ref, _abs_terms(case["src"], T, tf, params, gamma,
                                        isotropic))


def _register_pair(case, key, jparams, params, init=None):
    jmap, tmap = case["maps"][key]
    jspec, spec = (JSPEC, SPEC) if key == "fine" else (CUBE_JSPEC, CUBE_SPEC)
    init = case["init"] if init is None else init
    jsrc, tsrc = _src(case)
    jf = jndt.ndt_field(jmap, jspec, jparams,
                        center=jnp.asarray(init[:3, 3]))
    tf = ndt.ndt_field(tmap, spec, params,
                       center=torch.as_tensor(init[:3, 3]))
    jr = jndt.ndt_register(jsrc, jf, jspec, init_T=jnp.asarray(init),
                           params=jparams)
    tr = ndt.ndt_register(tsrc, tf, spec, init_T=torch.as_tensor(init),
                          params=params)
    return jf, tf, jr, tr


def _assert_pose(tr, jr):
    assert tr.iterations == int(jr.iterations)
    d = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(np.asarray(jr.T))
                                        @ tr.T.numpy())))
    assert np.linalg.norm(d[:3]) < 1e-4 and np.linalg.norm(d[3:]) < 1e-4
    assert float(tr.matched_fraction) == pytest.approx(
        float(jr.matched_fraction), abs=1e-6)


@pytest.mark.parametrize("isotropic_iterations", [0, 3])
def test_register_sparse_path_matches_reference(case, isotropic_iterations):
    """terms_impl "xla" on both sides: GNC coarse stage then the fine
    stage, after an isotropic stage when asked."""
    kw = dict(max_iterations=12, isotropic_iterations=isotropic_iterations,
              coarse_iterations=4, min_voxel_count=3.0)
    jf, tf, jr, tr = _register_pair(case, "fine",
                                    jndt.NDTParams(terms_impl="xla", **kw),
                                    ndt.NDTParams(terms_impl="xla", **kw))
    assert tf.rows is None
    _assert_pose(tr, jr)
    d = np.asarray(jse3.log(jnp.asarray(np.linalg.inv(case["T_true"])
                                        @ tr.T.numpy())))
    assert np.linalg.norm(d[:3]) < 0.05


def test_register_kernel_path_cube_window_matches_reference(case,
                                                            monkeypatch):
    """terms_impl "auto" (the port's kernel path) against the reference's
    "pallas_interpret" with its raster reference: no window_dims, so both
    build the 2^window_bits cube, here 16 cells a side inside a 32-cell
    grid around the init."""
    monkeypatch.setattr(j_terms, "ndt_terms_raster", _reference_terms)
    kw = dict(max_iterations=10, coarse_iterations=3, min_voxel_count=3.0,
              window_bits=4, max_corr_dist=2.0)
    jf, tf, jr, tr = _register_pair(
        case, "cube", jndt.NDTParams(terms_impl="pallas_interpret", **kw),
        ndt.NDTParams(terms_impl="auto", **kw))
    assert tf.window_dims == jf.window_dims == (16, 16, 16)
    np.testing.assert_array_equal(tf.origin_cell.numpy(),
                                  np.asarray(jf.origin_cell))
    _assert_pose(tr, jr)
    with pytest.raises(ValueError, match="isotropic"):
        ndt.ndt_register(_src(case)[1], tf, CUBE_SPEC,
                         params=ndt.NDTParams(isotropic_iterations=2))
