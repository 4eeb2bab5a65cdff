"""Gather of 32,768 rows from a (4,096, 16) float32 table, six ways.

Port of ``benchmarks/_pallas_gather_probe.py``, which asked which lowering
of a row gather from a VMEM-resident table a TPU kernel could use. Its five
kernel bodies compute two functions, each one kernel of
``kernels/gather.py`` here:

  1. take along axis 0              gather_rows(table, idx)
  2. take_along_axis, broadcast idx gather_rows(table, idx (N, 16))
  3. advanced indexing              gather_rows(table, idx)
  4. one-hot product in bfloat16    onehot_gather(table, idx, bf16=True)
  5. per-index row copy loop        gather_rows(table, idx)
  6. the framework's own take       table.index_select(0, idx) (no kernel)

Run on the card: ``python -m tpu_slam_torch.benchmarks._pallas_gather_probe``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.kernels.gather import gather_rows, onehot_gather
from tpu_slam_torch.utils.devtime import call_ms, device_label

N = 32768
T = 4096


def main(device=None, n: int = N, t: int = T, reps: int = 20) -> dict:
    """Time each variant at n indices into a (t, 16) table; each result is
    checked against numpy's gather (bit-equal; bfloat16-rounded for 4)."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    idx_h = rng.integers(0, t, n).astype(np.int32)
    table_h = rng.normal(size=(t, 16)).astype(np.float32)
    idx = torch.as_tensor(idx_h, device=dev)
    table = torch.as_tensor(table_h, device=dev)
    idx_bcast = idx[:, None].expand(n, 16).contiguous()
    want = table_h[idx_h]
    want_bf16 = (torch.as_tensor(table_h).to(torch.bfloat16)
                 .to(torch.float32).numpy()[idx_h])
    variants = {
        "1. take axis0": (lambda: gather_rows(table, idx), want),
        "2. take_along_axis bcast": (lambda: gather_rows(table, idx_bcast),
                                     want),
        "3. advanced indexing": (lambda: gather_rows(table, idx), want),
        "4. one-hot product bf16": (
            lambda: onehot_gather(table, idx, bf16=True), want_bf16),
        "5. per-index row copy": (lambda: gather_rows(table, idx), want),
        "6. torch index_select": (lambda: table.index_select(0, idx), want),
    }
    out = {}
    for name, (fn, expect) in variants.items():
        ms = call_ms(fn, reps, dev)
        out[name] = dict(ms=ms, gidx_per_s=n / (ms * 1e-3) / 1e9,
                         correct=bool(np.array_equal(fn().cpu().numpy(),
                                                     expect)))
    return dict(probe="pallas_gather", device=device_label(dev), n=n,
                table_rows=t, variants=out)


if __name__ == "__main__":
    print(json.dumps(main()))
