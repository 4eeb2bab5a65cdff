"""Equal-shape, per-lane and sub-shape gathers, and a one-hot gather.

Port of ``benchmarks/_dyngather_probe.py``, which asked which forms of
``take_along_axis`` a TPU kernel could lower and how fast. Every kernel
body there is one of two functions of ``kernels/gather.py`` here:

  1. equal shape (32,768, 16), one index a row      gather_rows
  2. equal shape (8,192, 128), one index a row      gather_rows
  3. per-element indices (8,192, 128)               gather_rows
  4. 4,096 rows of per-element indices from 8,192   gather_rows
  5. one-hot product in float32, 256 of 2,048 rows  onehot_gather

Run on the card: ``python -m tpu_slam_torch.benchmarks._dyngather_probe``.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from tpu_slam_torch import default_device
from tpu_slam_torch.kernels.gather import gather_rows, onehot_gather
from tpu_slam_torch.utils.devtime import call_ms, device_label


def main(device=None, n: int = 32768, m: int = 8192, ns: int = 4096,
         n_oh: int = 256, rows_oh: int = 2048, reps: int = 20) -> dict:
    """Time each form; each result is checked bit for bit against numpy's
    take_along_axis (the one-hot form against numpy's row gather)."""
    dev = default_device(device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731

    table = rng.normal(size=(n, 16)).astype(np.float32)
    idx = rng.integers(0, n, (n,)).astype(np.int32)
    tab128 = rng.normal(size=(m, 128)).astype(np.float32)
    idxm = rng.integers(0, m, (m,)).astype(np.int32)
    idx_lane = rng.integers(0, m, (m, 128)).astype(np.int32)
    idxs = rng.integers(0, m, (ns, 128)).astype(np.int32)
    tab2k = rng.normal(size=(rows_oh, 128)).astype(np.float32)
    idx_oh = rng.integers(0, rows_oh, (n_oh, 1)).astype(np.int32)

    def bcast(i, cols):
        return np.ascontiguousarray(np.broadcast_to(i[:, None],
                                                    (len(i), cols)))

    cases = {
        "equal-shape take_along_axis (32k,16)": (table, bcast(idx, 16)),
        "equal-shape take_along_axis (8k,128)": (tab128, bcast(idxm, 128)),
        "per-lane idx take_along_axis (8k,128)": (tab128, idx_lane),
        "sub-shape take_along_axis (4k out of 8k)": (tab128, idxs),
    }
    out = {}
    for name, (tab_h, idx_h) in cases.items():
        tab_d, idx_d = t(tab_h), t(idx_h)
        ms = call_ms(lambda: gather_rows(tab_d, idx_d), reps, dev)
        got = gather_rows(tab_d, idx_d).cpu().numpy()
        rows = idx_h.shape[0]
        out[name] = dict(
            ms=ms, g_rows_per_s=rows / (ms * 1e-3) / 1e9,
            gb_per_s=got.nbytes / (ms * 1e-3) / 1e9,
            correct=bool(np.array_equal(
                got, np.take_along_axis(tab_h, idx_h, axis=0))))
    tab_d, idx_d = t(tab2k), t(idx_oh[:, 0].copy())
    name = "one-hot product f32 (256 of 2048)"
    out[name] = dict(
        ms=call_ms(lambda: onehot_gather(tab_d, idx_d), reps, dev),
        correct=bool(np.array_equal(onehot_gather(tab_d, idx_d).cpu().numpy(),
                                    tab2k[idx_oh[:, 0]])))
    return dict(probe="dyngather", device=device_label(dev), forms=out)


if __name__ == "__main__":
    print(json.dumps(main()))
