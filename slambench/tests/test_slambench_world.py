"""The benchmark's scan generator against ``tpu_slam_torch.ingest.synthetic``
at a tiny size."""

import numpy as np
import pytest
import torch

from slambench import world
from tpu_slam_torch.ingest import synthetic as syn


def _arrays(patches):
    return [np.stack([p[i] for p in patches]) for i in range(3)]


@pytest.mark.parametrize("name, kw, theirs", [
    ("dense_city", dict(extent=200.0, block_pitch=24.0, seed=0),
     lambda: syn.dense_city(extent=200.0, block_pitch=24.0, seed=0)),
    ("ring_corridor", dict(outer=(30.0, 22.0, 3.0), inner=(18.0, 10.0)),
     syn.ring_corridor)])
def test_worlds_match(name, kw, theirs):
    mine = _arrays(world.make_world(dict(kind=name, **kw)))
    ref = theirs()
    for got, attr in zip(mine, ("origin", "u", "v")):
        want = np.stack([getattr(p, attr) for p in ref.patches])
        np.testing.assert_array_equal(got, want)


def test_corridor_route_matches():
    got = world.make_route({"shape": "rounded_rect", "half": [12.0, 8.0],
                            "corner_radius": 3.0, "z": 1.2, "step": 0.6,
                            "speed_var": 0.35}, 250)
    np.testing.assert_array_equal(
        got, syn.corridor_route(250, step=0.6, speed_var=0.35))


def test_city_lap_closes():
    lap = world.make_route({"shape": "rounded_rect", "center": [-4.0, -4.0],
                            "half": [24.0, 24.0], "corner_radius": 8.0,
                            "z": 1.8, "lap_scans": 112}, 113)
    np.testing.assert_allclose(lap[112], lap[0], atol=1e-9)
    np.testing.assert_allclose(lap[0][:3, 3], [-20.0, -28.0, 1.8])
    step = np.linalg.norm(np.diff(lap[:, :3, 3], axis=0), axis=1)
    assert step.max() < 1.6 and step.min() > 1.5


@pytest.mark.parametrize("name", ["dense_city", "ring_corridor"])
def test_scans_match_the_simulator(name):
    """Noise-free scans: the same returns as simulate_vlp16_revolution
    (in the seed's order), ranges within float32 rounding."""
    spec = {"dense_city": dict(kind="dense_city"),
            "ring_corridor": dict(kind="ring_corridor")}[name]
    theirs = {"dense_city": syn.dense_city,
              "ring_corridor": syn.ring_corridor}[name]()
    poses = (world.make_route({"shape": "rounded_rect",
                               "center": [-4.0, -4.0], "half": [24.0, 24.0],
                               "corner_radius": 8.0, "z": 1.8,
                               "lap_scans": 112}, 3)
             if name == "dense_city" else syn.corridor_route(3, step=0.6))
    sensor = dict(model="vlp16", n_azimuth=64, max_range=40.0, noise_std=0.0,
                  capacity=1100, noise_seed=0)
    pts, msk = world.make_scans(world.make_world(spec), poses, sensor,
                                seed=5, device="cpu")
    for k, T in enumerate(poses):
        p, valid = syn.simulate_vlp16_revolution(
            theirs, T, n_azimuth=64, max_range=40.0, device="cpu")
        want = p[valid]
        n = want.shape[0]
        assert int(msk[k].sum()) == n
        got = pts[k, :n].numpy()
        # the seed's order: match each return to the simulator's by ray
        d = np.linalg.norm(got[:, None, :] - want[None, :, :], axis=-1)
        assert d.min(axis=1).max() < 2e-4
        assert len(set(d.argmin(axis=1).tolist())) == n
        assert torch.all(pts[k, n:] == world.PAD_COORD)


def test_seed_orders_the_same_returns():
    """The noise is one fixed draw; the seed only orders each scan's
    returns: the same points for every seed, in another order."""
    spec = dict(kind="ring_corridor")
    poses = syn.corridor_route(2, step=0.6)
    sensor = dict(model="vlp16", n_azimuth=32, max_range=20.0, noise_std=0.02,
                  capacity=600, noise_seed=0)
    a, ma = world.make_scans(world.make_world(spec), poses, sensor,
                             2**33 + 1, "cpu")
    b, _ = world.make_scans(world.make_world(spec), poses, sensor,
                            2**33 + 1, "cpu")
    c, mc = world.make_scans(world.make_world(spec), poses, sensor,
                             2**33 + 2, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(ma, mc)
    for k in range(2):
        n = int(ma[k].sum())
        key = lambda p: p[np.lexsort(p.T[::-1])]
        np.testing.assert_array_equal(key(a[k, :n].numpy()),
                                      key(c[k, :n].numpy()))
