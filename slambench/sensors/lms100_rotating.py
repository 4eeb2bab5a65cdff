"""``lms100_rotating``: a SICK LMS100 on the m3d rotating unit, the base
standing still at each stop while the unit turns on without a break.

A stop's scan is ``lines`` lines of ``beams`` returns at ``step_deg``
from ``start_deg`` (the laser frame, ``lms_poller.cpp:74``), line k of the
run at encoder angle ``encoder_phase + k * turn / (lines - 1.5)``, wrapped
to [0, 2 pi): 1.1 pi in 148.5 steps makes 150 lines a scan (the first
latches, the 150th passes the aggregator's trigger). Each line is cast
from the route's base pose at its stop through the unit's frame chain
(``slambench.reference.aggregator.base_from_laser``). A return is valid
within [min_range, max_range] and carries Gaussian range noise of
``noise_std`` from a generator seeded with ``noise_seed``, the same in
every run.

The run's seed draws ``encoder_phase``, the encoder angle at the first
line (where a real unit stands at a stop is arbitrary), and writes it
into the sensor object, which the driver and the check read: the scans
carry no angle. ``scans`` returns, on the host as a recorded survey is,
each stop's points in the laser frame (``lines * beams`` rows, line
after line, (0, 0, 0) where no return) and their valid flags.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from slambench.reference.aggregator import base_from_laser, beam_directions
from slambench.world import raycast


def line_step(sensor: Dict) -> float:
    """Encoder rad between consecutive lines."""
    return sensor["turn"] / (sensor["lines"] - 1.5)


def draw_phase(seed: int) -> float:
    return float(np.random.default_rng(int(seed) % (1 << 63)).uniform(
        0.0, 2.0 * math.pi))


def line_angles(sensor: Dict, stop: int) -> np.ndarray:
    """(lines,) float64 encoder angles of a stop's lines, in [0, 2 pi)."""
    k = stop * sensor["lines"] + np.arange(sensor["lines"])
    return np.mod(sensor["encoder_phase"] + k * line_step(sensor),
                  2.0 * math.pi)


def line_ranges(points: torch.Tensor, sensor: Dict) -> np.ndarray:
    """A stop's (lines * beams, 3) laser-frame points -> (lines, beams)
    float32 ranges (0 where no return), as the scanner reports them."""
    p = points.cpu().numpy().reshape(sensor["lines"], sensor["beams"], 3)
    return np.hypot(p[..., 0], p[..., 1])


def scans(patches, poses, sensor, seed, device,
          batch_rays: int = 1 << 26):
    dev = torch.device(device)
    sensor["encoder_phase"] = draw_phase(seed)
    L, n = sensor["lines"], sensor["beams"]
    dirs_l = torch.as_tensor(beam_directions(n, sensor["start_deg"],
                                             sensor["step_deg"]),
                             dtype=torch.float64, device=dev)
    noise_gen = torch.Generator(device=dev)
    noise_gen.manual_seed(int(sensor["noise_seed"]))
    n_stops = len(poses)
    pts_out = torch.zeros((n_stops, L * n, 3), dtype=torch.float32)
    msk_out = torch.zeros((n_stops, L * n), dtype=torch.bool)
    per = max(1, batch_rays // (L * n * len(patches)))
    for s0 in range(0, n_stops, per):
        stops = range(s0, min(n_stops, s0 + per))
        T = np.concatenate([poses[s] @ base_from_laser(line_angles(sensor, s))
                            for s in stops])                  # (B*L, 4, 4)
        Tw = torch.as_tensor(T, dtype=torch.float64, device=dev)
        dirs_w = (dirs_l @ Tw[:, :3, :3].transpose(1, 2)).to(torch.float32)
        r = raycast(patches, Tw[:, :3, 3].to(torch.float32), dirs_w)
        valid = ((r >= sensor["min_range"]) & (r <= sensor["max_range"]))
        noise = torch.randn(r.shape, generator=noise_gen, device=dev,
                            dtype=torch.float32) * sensor["noise_std"]
        rng = torch.where(valid, r + noise, 0.0)
        p = dirs_l.to(torch.float32)[None] * rng[..., None]
        b = len(stops)
        pts_out[s0:s0 + b] = p.reshape(b, L * n, 3).cpu()
        msk_out[s0:s0 + b] = valid.reshape(b, L * n).cpu()
    return pts_out, msk_out
