"""``ring_corridor``: an office floor's ring corridor round a core
(``tpu_slam_torch.ingest.synthetic.ring_corridor``'s patches, in its
order)."""

from __future__ import annotations

from typing import List

import numpy as np

from slambench.world import Patch, box


def patches(outer=(30.0, 22.0, 3.0), inner=(18.0, 10.0)) -> List[Patch]:
    """A rectangular ring corridor round a core: floor, ceiling, four
    walls, the core, six cabinets and shallow door frames every ~6 m."""
    ox, oy, oz = outer
    ix, iy = inner
    e = np.array
    boxes = [(e([-ix / 2, -iy / 2, 0.0]), e([ix / 2, iy / 2, oz])),
             (e([-ix / 4, -oy / 2 + 0.6, 0.0]),
              e([-ix / 4 + 0.5, -oy / 2 + 1.1, 2.2])),
             (e([ix / 4, oy / 2 - 1.1, 0.0]),
              e([ix / 4 + 0.5, oy / 2 - 0.6, 2.2])),
             (e([ox / 2 - 1.0, -iy / 4, 0.0]),
              e([ox / 2 - 0.4, -iy / 4 + 0.8, 1.4])),
             (e([-ox / 2 + 0.4, iy / 4, 0.0]),
              e([-ox / 2 + 1.0, iy / 4 + 0.8, 1.4])),
             (e([0.0, -iy / 2 - 0.9, 0.0]), e([0.6, -iy / 2 - 0.3, 1.8])),
             (e([-0.6, iy / 2 + 0.3, 0.0]), e([0.0, iy / 2 + 0.9, 1.8]))]
    for x in np.arange(-ox / 2 + 4.0, ox / 2 - 3.0, 6.0):
        boxes.append((e([x, -oy / 2, 0.0]),
                      e([x + 0.25, -oy / 2 + 0.15, 2.1])))
        boxes.append((e([x + 1.1, oy / 2 - 0.15, 0.0]),
                      e([x + 1.35, oy / 2, 2.1])))
    for y in np.arange(-oy / 2 + 4.0, oy / 2 - 3.0, 6.0):
        boxes.append((e([-ox / 2, y, 0.0]),
                      e([-ox / 2 + 0.15, y + 0.25, 2.1])))
        boxes.append((e([ox / 2 - 0.15, y + 1.1, 0.0]),
                      e([ox / 2, y + 1.35, 2.1])))
    x0, x1, y0, y1 = -ox / 2, ox / 2, -oy / 2, oy / 2
    out = [
        (e([x0, y0, 0.0]), e([ox, 0, 0]), e([0, oy, 0])),
        (e([x0, y0, oz]), e([ox, 0, 0]), e([0, oy, 0])),
        (e([x0, y0, 0.0]), e([ox, 0, 0]), e([0, 0, oz])),
        (e([x0, y1, 0.0]), e([ox, 0, 0]), e([0, 0, oz])),
        (e([x0, y0, 0.0]), e([0, oy, 0]), e([0, 0, oz])),
        (e([x1, y0, 0.0]), e([0, oy, 0]), e([0, 0, oz])),
    ]
    for lo, hi in boxes:
        out += box(lo, hi)
    return out
