"""``dense_city``: a ground plane and box buildings on a street grid
(``tpu_slam_torch.ingest.synthetic.dense_city``'s patches, in its order)."""

from __future__ import annotations

from typing import List

import numpy as np

from slambench.world import Patch


def patches(extent: float = 200.0, block_pitch: float = 24.0,
            road_halfwidth: float = 7.0, seed: int = 0) -> List[Patch]:
    """A ground plane and box buildings on a street grid (streets every
    ``block_pitch`` m, building heights 6-18 m from ``seed``)."""
    rng = np.random.default_rng(seed)
    e = np.array
    h = extent / 2
    out = [(e([-h, -h, 0.0]), e([extent, 0, 0]), e([0, extent, 0]))]
    n_cells = int(extent // block_pitch)
    for i in range(n_cells):
        for j in range(n_cells):
            cx = -h + (i + 0.5) * block_pitch
            cy = -h + (j + 0.5) * block_pitch
            w = block_pitch - 2 * road_halfwidth - rng.uniform(0, 2)
            d = block_pitch - 2 * road_halfwidth - rng.uniform(0, 2)
            if w < 3 or d < 3:
                continue
            x, y = cx - w / 2, cy - d / 2
            z = rng.uniform(6, 18)
            lo = e([x, y, 0.0])
            hi = e([x + w, y + d, z])
            dd = hi - lo
            out += [
                (e([lo[0], lo[1], hi[2]]), e([dd[0], 0, 0]),
                 e([0, dd[1], 0])),
                (lo, e([dd[0], 0, 0]), e([0, 0, dd[2]])),
                (e([lo[0], hi[1], lo[2]]), e([dd[0], 0, 0]),
                 e([0, 0, dd[2]])),
                (lo, e([0, dd[1], 0]), e([0, 0, dd[2]])),
                (e([hi[0], lo[1], lo[2]]), e([0, dd[1], 0]),
                 e([0, 0, dd[2]])),
            ]
    return out
