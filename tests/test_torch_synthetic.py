"""The port's copies of tpu_slam's synthetic worlds and routes (CPU).

The port keeps its own copy of the numpy-only scene code; these hold each
copy against the original: the same patches, the same route poses, and the
same simulated scan from the same seed.
"""

import numpy as np
import pytest

from tpu_slam.ingest import synthetic as jsyn
from tpu_slam_torch.ingest import synthetic as syn


def _patches(world):
    return np.stack([np.concatenate([p.origin, p.u, p.v])
                     for p in world.patches])


@pytest.mark.parametrize("name, kw", [
    ("ring_corridor", {}),
    ("ring_corridor", dict(outer=(20.0, 16.0, 3.0), inner=(10.0, 6.0))),
    ("default_office", {}),
    ("outdoor_block", dict(seed=1)),
    ("outdoor_block", dict(n_buildings=12, extent=80.0, seed=4)),
])
def test_worlds_equal_reference(name, kw):
    np.testing.assert_array_equal(_patches(getattr(syn, name)(**kw)),
                                  _patches(getattr(jsyn, name)(**kw)))


@pytest.mark.parametrize("kw", [dict(n_poses=230, step=0.6, speed_var=0.35),
                                dict(n_poses=40), dict(n_poses=7, step=2.0,
                                                       corner_r=1.5)])
def test_corridor_route_equals_reference(kw):
    np.testing.assert_array_equal(syn.corridor_route(**kw),
                                  jsyn.corridor_route(**kw))


def test_corridor_scan_equals_reference():
    """The config-4 scan simulation: same world, pose, rays and noise."""
    T = jsyn.corridor_route(5, step=0.6, speed_var=0.35)[3]
    got = syn.simulate_vlp16_revolution(
        syn.ring_corridor(), T, n_azimuth=900, max_range=20.0,
        noise_std=0.02, rng=np.random.default_rng(0), device="cpu")
    ref = jsyn.simulate_vlp16_revolution(
        jsyn.ring_corridor(), T, n_azimuth=900, max_range=20.0,
        noise_std=0.02, rng=np.random.default_rng(0))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
