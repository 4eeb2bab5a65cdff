#!/usr/bin/env python3
"""Time the NN and row-gather kernels of tpu_slam_torch/csrc against their
earlier versions on one GPU, in turns (old, new, new, old), in one process.

The earlier versions are the sources of commit 966dd32, whose
``nn_search_launch`` takes no split plan; they are not kept in the tree:

    mkdir -p _checkout/old
    git show 966dd32:tpu_slam_torch/csrc/nn_search.cu > _checkout/old/nn_search.cu
    git show 966dd32:tpu_slam_torch/csrc/gather.cu > _checkout/old/gather.cu
    python3 compare_kernels.py _checkout/old [--config4]

Both versions are built with the same nvcc flags and run on the same
tensors: config 1's first NN pass at 8k, 64k and 128k points, a seeded
6 x 4,096 batch, config 4's verification batch (``--config4``: runs the
SLAM phase first, ~2.5 minutes), a 300 x 200,000 case that the new kernel
splits, and the gather probes' rows 4, 6 and 7 plus a misaligned view and
a 7-column table. For each case one JSON line: the device us of each turn
(the profiler's mean over the events it saw), the CUDA-event us of each
turn, the SM clock after each, the events seen, whether old and new (and
the plain version, where it fits) agree bit for bit; for the gathers also
the wrapper's and the library call's ms, in turns.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from tpu_slam_torch.kernels import _build
from tpu_slam_torch.kernels import gather as G
from tpu_slam_torch.kernels import nn_search as NN

VP, CI = ctypes.c_void_p, ctypes.c_int


def build_old(src: pathlib.Path, name: str) -> ctypes.CDLL:
    out = _build.BUILD_DIR / f"lib{name}-old.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(out), str(src)], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr)
    return ctypes.CDLL(str(out))


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def turns(label, old, new, reps, **extra):
    from torch.autograd import DeviceType

    res = {"case": label}
    for tag, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        per, prof = cs.device_time_us(fn, reps)
        res.setdefault(tag + "_device_us", []).append(sum(per.values()))
        res.setdefault(tag + "_event_us", []).append(
            cs.time_ms(fn, reps) * 1e3)
        res.setdefault(tag + "_clock", []).append(cs.clocks_now())
        res[tag + "_events_seen"] = {
            e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    res["new_over_old"] = (sum(res["new_device_us"])
                           / sum(res["old_device_us"]))
    print(json.dumps({**res, **extra}), flush=True)


def nn_cases(dev, config4):
    cases = []
    for n_az, label in ((512, "c1_8k"), (4096, "c1_64k"), (8192, "c1_128k")):
        src, tgt, _ = cs.config1_pair(dev, n_az)
        cases.append((label, src.points[None].contiguous(),
                      tgt.points[None].contiguous()))
    g = torch.Generator().manual_seed(0)
    q = torch.rand(6, 4096, 3, generator=g) * 20 - 10
    t = torch.rand(6, 4096, 3, generator=g) * 20 - 10
    q[:, 3500:] = 1e8
    t[:, 3600:] = 1e8
    cases.append(("batch_6x4096", q.to(dev), t.to(dev)))
    if config4:
        clouds, gt = cs.config4_scans("cuda")
        run = cs.phase_slam(clouds, gt)
        q, t, _, _ = cs.verification_batch(run["state"], cs.config4())
        cases.append(("config4_verify", q, t))
    q, t, _, _ = cs.nn_split_case(dev)
    cases.append(("split_300x200k", q[None].contiguous(),
                  t[None].contiguous()))
    return cases


def compare_nn(old_lib, dev, config4):
    old_fn = old_lib.nn_search_launch
    old_fn.argtypes = [VP, VP, CI, CI, CI, VP, VP, VP]
    for label, q, t in nn_cases(dev, config4):
        b, n, m = q.shape[0], q.shape[1], t.shape[1]
        i_old = torch.empty((b, n), dtype=torch.int32, device=dev)
        d_old = torch.empty((b, n), device=dev)

        def old():
            assert old_fn(q.data_ptr(), t.data_ptr(), b, n, m,
                          i_old.data_ptr(), d_old.data_ptr(), stream()) == 0

        def new():
            return NN.nearest_neighbors(q, t, squared=True)

        i_new, d_new = new()
        old()
        torch.cuda.synchronize()
        same = torch.equal(i_old, i_new) and torch.equal(d_old, d_new)
        plain = None
        if b * n * m <= 1 << 28:
            pi, pd = NN.nearest_neighbors_plain(q, t, squared=True)
            plain = torch.equal(pi, i_new) and torch.equal(pd, d_new)
        splits, chunk = NN.split_plan(b, n, m)
        turns(f"nn_search {label}", old, new, 20 if b * n * m < 1 << 30
              else 5, shape=[b, n, m], splits=splits, chunk=chunk,
              old_equals_new=same, new_equals_plain=plain)
        if not same or plain is False:
            raise AssertionError(f"nn_search {label}: results differ")


def compare_gather(old_lib, dev):
    old_fn = old_lib.gather_rows_launch
    old_fn.argtypes = [VP, CI, CI, VP, CI, CI, VP, VP]
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    tab4k = t(rng.normal(size=(4096, 16)).astype(np.float32))
    idx32k = t(rng.integers(0, 4096, 32768).astype(np.int32))
    tab8k = t(rng.normal(size=(8192, 128)).astype(np.float32))
    lane = t(rng.integers(0, 8192, (8192, 128)).astype(np.int32))
    sub = t(rng.integers(0, 8192, (4096, 128)).astype(np.int32))
    big = t(rng.normal(size=4096 * 16 + 1).astype(np.float32))
    off = big[1:].view(4096, 16)
    tab7 = t(rng.normal(size=(4096, 7)).astype(np.float32))
    cases = [("row4", tab4k, idx32k, lambda: tab4k.index_select(0, idx32k)),
             ("row6", tab8k, lane, lambda l=lane.long():
              torch.take_along_dim(tab8k, l, 0)),
             ("row7", tab8k, sub, lambda s=sub.long():
              torch.take_along_dim(tab8k, s, 0)),
             ("misaligned", off, idx32k, lambda: off.index_select(0, idx32k)),
             ("cols7", tab7, idx32k, lambda: tab7.index_select(0, idx32k))]
    for label, table, idx, library in cases:
        m, cols = idx.shape[0], table.shape[1]
        out_old = torch.empty((m, cols), device=dev)

        def old():
            assert old_fn(table.data_ptr(), table.shape[0], cols,
                          idx.data_ptr(), int(idx.dim() == 2), m,
                          out_old.data_ptr(), stream()) == 0

        def new():
            return G.gather_rows(table, idx)

        got = new()
        old()
        torch.cuda.synchronize()
        same = torch.equal(out_old, got) and torch.equal(
            got, G.gather_rows_plain(table, idx))
        wrapper, lib = [], []
        for fn, into in ((new, wrapper), (library, lib), (library, lib),
                         (new, wrapper)):
            into.append(cs.time_ms(fn, 200))
        turns(f"gather_rows {label}", old, new, 50, equal=same,
              wrapper_ms=wrapper, library_ms=lib)
        if not same:
            raise AssertionError(f"gather_rows {label}: results differ")


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old_dir = pathlib.Path(sys.argv[1])
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    cs.phase_build()
    compare_nn(build_old(old_dir / "nn_search.cu", "nn_search"), dev,
               "--config4" in sys.argv)
    compare_gather(build_old(old_dir / "gather.cu", "gather"), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
