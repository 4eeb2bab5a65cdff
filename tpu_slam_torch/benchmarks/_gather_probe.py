"""Candidate lowerings of the NDT terms pass's gathers, at 32k points.

Port of ``benchmarks/_gather_probe.py``, which measured on the TPU what a
per-point gather from a 64^3 window of field rows costs in each form. The
forms that were framework ops there are plain torch ops here; the one
kernel body (d) is ``gather_row_sum`` of ``kernels/gather.py``:

  a. tier-9 gather: 3 indices a point into (G, 144) rows, summed
  b. tier-0 gather: 27 indices a point into (G, 16) rows, summed
  c0. dense raster scatter: sort, rank in segment, scatter into (G, 4Q)
  c1. 27 rolls of the (G, 16) rows against that raster
  d. kernel: row gather and row sum, 32,768 indices into (32,768, 16)
  e. one-hot product gather in bfloat16 over a 4,096-row slab

Run on the card: ``python -m tpu_slam_torch.benchmarks._gather_probe``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.kernels.gather import gather_row_sum
from tpu_slam_torch.utils.devtime import call_ms, device_label

N = 32768          # scan points
WB = 6             # window bits
Q = 4              # raster per-cell point capacity


def main(device=None, n: int = N, wb: int = WB, q: int = Q,
         reps: int = 20) -> dict:
    """Time each form at n points in a (2^wb)^3 window; the kernel's row
    sums are checked bit for bit against numpy's left-to-right sums."""
    dev = default_device(device)
    w = 1 << wb
    g = w ** 3
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(1, w - 1, (n, 3)).astype(np.float32),
                          device=dev)
    cc = pts.to(torch.int32)
    key = (cc[:, 0] * w + cc[:, 1]) * w + cc[:, 2]
    rows16_h = rng.normal(size=(g, 16)).astype(np.float32)
    rows16 = torch.as_tensor(rows16_h, device=dev)
    rows144 = torch.as_tensor(rng.normal(size=(g, 144)).astype(np.float32),
                              device=dev)
    d3 = torch.tensor([-1, 0, 1], dtype=torch.int32, device=dev)
    doff = (d3[:, None, None] * w * w + d3[None, :, None] * w
            + d3[None, None, :]).reshape(-1)

    def tier9():
        starts = key[:, None] + d3 * (w * w)
        rows = rows144[torch.clamp(starts, 0, g - 1)]
        return rows.reshape(n, 27, 16).sum(dim=(1, 2))

    def tier0():
        rows = rows16[torch.clamp(key[:, None] + doff, 0, g - 1)]
        return rows.sum(dim=(1, 2))

    def raster_scatter():
        order = torch.argsort(key, stable=True)
        sk, sp = key[order], pts[order]
        i = torch.arange(n, device=dev)
        is_start = torch.ones(n, dtype=torch.bool, device=dev)
        is_start[1:] = sk[1:] != sk[:-1]
        seg_start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
        rank = i - seg_start
        flat = torch.where(rank < q, sk * q + rank, g * q)
        R = torch.zeros((g * q + 1, 4), dtype=torch.float32, device=dev)
        R[flat] = torch.cat([sp, torch.ones((n, 1), device=dev)], dim=1)
        return R[:g * q].reshape(g, q * 4)

    R = raster_scatter()

    def roll_terms():
        acc = torch.zeros(g, device=dev)
        Rr = R.reshape(g, q, 4)
        p, m = Rr[:, :, :3], Rr[:, :, 3]
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    rr = torch.roll(rows16, -((dx * w + dy) * w + dz), 0)
                    r = p - rr[:, None, 0:3]
                    d2 = (r * r).sum(dim=-1) * rr[:, None, 3]
                    s = torch.exp(-0.5 * torch.clamp(d2, max=30.0)) * m
                    acc = acc + (s * d2).sum(dim=1)
        return acc

    lim = min(g, 1 << 15)          # a table small enough for one TPU block
    table_d = rows16[:lim]
    key_d = torch.clamp(key, 0, lim - 1)
    sl = min(g, 1 << 12)           # slab rows
    slab_bf16 = rows16[:sl].to(torch.bfloat16).to(torch.float32)

    def onehot():
        oh = torch.nn.functional.one_hot((key % sl).long(), sl)
        return (oh.to(torch.float32) @ slab_bf16).sum(dim=1)

    forms = {"a. tier-9 gather (3 idx/pt)": tier9,
             "b. tier-0 gather (27 idx/pt)": tier0,
             "c0. raster scatter (sort+set)": raster_scatter,
             "c1. raster 27-roll terms": roll_terms,
             "d. kernel gather_row_sum": lambda: gather_row_sum(table_d,
                                                                key_d),
             "e. one-hot product gather bf16": onehot}
    out = {name: dict(ms=call_ms(fn, reps, dev)) for name, fn in forms.items()}
    rows = rows16_h[:lim][key_d.cpu().numpy()]
    want = rows[:, 0].copy()
    for j in range(1, 16):
        want = want + rows[:, j]
    got = gather_row_sum(table_d, key_d).cpu().numpy()
    out["d. kernel gather_row_sum"]["correct"] = bool(np.array_equal(got,
                                                                     want))
    return dict(probe="gather", device=device_label(dev), n=n, window=w,
                q=q, forms=out)


if __name__ == "__main__":
    print(json.dumps(main()))
