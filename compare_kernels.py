#!/usr/bin/env python3
"""Time the redesigned kernels of tpu_slam_torch/csrc against their earlier
versions on one GPU, in turns (old, new, new, old), in one process.

The earlier versions are not kept in the tree. ``nn_search.cu`` and
``gather.cu`` of commit 966dd32 (whose ``nn_search_launch`` takes no split
plan), ``ndt_terms.cu`` and ``icp_terms.cu`` of commit 00c6537 (one thread
a slot, a grid of ceil(n / 256) blocks writing per-block partials that the
wrapper sums), ``gather.cu`` of commit 3191f90 (``gather_row_sum`` one
thread a row, ``onehot_gather`` one thread an element); each comparison
runs when its old source is in the directory given:

    mkdir -p _checkout/old
    git show 966dd32:tpu_slam_torch/csrc/nn_search.cu > _checkout/old/nn_search.cu
    git show 966dd32:tpu_slam_torch/csrc/gather.cu > _checkout/old/gather.cu
    git show 3191f90:tpu_slam_torch/csrc/gather.cu > _checkout/old/gather_3191f90.cu
    git show 00c6537:tpu_slam_torch/csrc/ndt_terms.cu > _checkout/old/ndt_terms.cu
    git show 00c6537:tpu_slam_torch/csrc/icp_terms.cu > _checkout/old/icp_terms.cu
    python3 compare_kernels.py _checkout/old [--config4] [--sweep] [--orders]

Both versions are built with the same nvcc flags and run on the same
tensors:

  nn_search    config 1's first NN pass at 8k, 64k and 128k points, a
               seeded 6 x 4,096 batch, config 4's verification batch
               (``--config4``: runs the SLAM phase first, ~2.5 minutes) and
               a 300 x 200,000 case that the new kernel splits;
  gather_rows  the gather probes' rows 4, 6 and 7, a misaligned view and a
               7-column table;
  gather_row_sum, onehot_gather
               row 5 (32,768 keys into a (32,768, 16) table), row 4's
               k_onehot (bf16, 32,768 of 4,096 x 16; gather_rows beside
               it), row 8 (256 of 2,048 x 128; index_select beside it),
               each on a misaligned view and at 200 columns, with the
               empty-kernel floor at the new kernel's grid;
  ndt_terms    config 2's fine (Q = 4) and wide (Q = 8) cases and config
               4's, each on its odometry engine warmed on the first scans;
  icp_terms    config 1's coarse and fine stage inputs at 8k and 32k and
               the three windows of benchmarks/_probe_icp_kernel.py.

For each case one JSON line: the device us of each turn (all of a call's
device work: the profiler's mean over the events it saw, summed over the
kernels), the CUDA-event us of each turn (the wrapper's host work
included), the SM clock after each, the events seen, and whether old, new
(and the plain version) agree: bit for bit for NN and gathers (the row
sum's new order only against its plain version, with the largest
difference from the old order beside); for the
terms the matched count exactly, each block of the sums within 1e-4 of
its largest magnitude, and for ICP each slot's chosen target. For the
gathers also the wrapper's and the library call's ms, in turns.

``--sweep`` times other block sizes of the gathers (-D GATHER_THREADS; see
``sweep_gather``), and other lane splits and grid sizes of the terms
kernels on the main cases (device us and the per-call time of a replayed
CUDA graph of 20 calls): each a build of the shipped source with -D NDT_TERMS_LANES,
ICP_TERMS_LANES and TERMS_MAX_BLOCKS, its matched count held to the plain
version's. ``--orders`` runs config 4 end to end (chip_smoke's
``phase_slam``) with other summation orders of the NDT sums: 4 and 32
lanes, a 132-block grid, and the old kernel with its wrapper's sum, each
in place of the shipped kernel; one line each with the keyframe ATE,
loops and keyframes (~2.5 minutes a run).

Every run also times empty kernels launched the same way (a ctypes call on
the current stream, after a torch.empty of the result): the floor that a
kernel of a few microseconds sits on.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import chip_smoke as cs
from tpu_slam_torch.kernels import _build
from tpu_slam_torch.kernels import gather as G
from tpu_slam_torch.kernels import icp_terms as I
from tpu_slam_torch.kernels import ndt_terms as N
from tpu_slam_torch.kernels import nn_search as NN

VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
TERMS_RTOL = 1e-4         # of each block's largest magnitude, as chip_smoke
SWEEP_LANES = (1, 4, 8, 32)
SWEEP_BLOCKS = (132, 264, 512)
SWEEP_GATHER_THREADS = (32, 64, 128, 256, 512, 1024)
NDT_ARGTYPES = [VP, VP, VP, CI, VP, VP, CI, CI, CI, CF, CF, VP, VP]
ICP_ARGTYPES = [VP, VP, VP, CI, VP, VP, CI, CI, CI, CI, CF, CF, VP, VP, VP]
EMPTY_SOURCE = r"""
#include <cuda_runtime.h>
__global__ void empty_kernel(float* out) {}
extern "C" int empty_launch(void* out, int blocks, int threads,
                            void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
"""


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


def turns(label, old, new, reps, graph=False, **extra):
    """Time ``old`` and ``new`` in turns (old, new, new, old), with the
    per-call us of a replayed CUDA graph of 20 calls if ``graph``; prints
    and returns the JSON line."""
    from torch.autograd import DeviceType

    res = {"case": label}
    for tag, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        per, prof = cs.device_time_us(fn, reps)
        res.setdefault(tag + "_device_us", []).append(sum(per.values()))
        res.setdefault(tag + "_event_us", []).append(
            cs.time_ms(fn, reps) * 1e3)
        if graph:
            res.setdefault(tag + "_graph_us", []).append(
                cs.graph_time_us(fn)[0])
        res.setdefault(tag + "_clock", []).append(cs.clocks_now())
        res[tag + "_events_seen"] = {
            e.key[:60]: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA}
    res["new_over_old"] = (sum(res["new_device_us"])
                           / sum(res["old_device_us"]))
    res["new_over_old_event"] = (sum(res["new_event_us"])
                                 / sum(res["old_event_us"]))
    print(json.dumps({**res, **extra}), flush=True)
    return res


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


def walker_blocks(cols, m, vec, unit, threads=256):
    """The grid of csrc/gather.cu's ``plan``: blocks of ``threads``, the
    row's units (float4s, or ``unit`` floats on the scalar path) rounded up
    to a power of two lanes, at most 32, at most 4,224 x 256 threads."""
    units = cols // 4 if vec else -(-cols // unit)
    lanes = 1
    while lanes < units and lanes < 32:
        lanes *= 2
    return min(-(-m // (threads // lanes)), 4224 * 256 // threads)


def row_sum_onehot_cases(dev):
    """(kernel, label, bf16, table, idx, yardstick) of the row sum's and the
    one-hot's comparison."""
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    tab4k = t(rng.normal(size=(4096, 16)).astype(np.float32))
    idx32k = t(rng.integers(0, 4096, 32768).astype(np.int32))
    tab32k = t(rng.normal(size=(32768, 16)).astype(np.float32))
    key32k = t(rng.integers(0, 32768, 32768).astype(np.int32))
    tab2k = t(rng.normal(size=(2048, 128)).astype(np.float32))
    idx256 = t(rng.integers(0, 2048, 256).astype(np.int32))
    off = t(rng.normal(size=4096 * 16 + 1).astype(np.float32))[1:].view(
        4096, 16)
    tab200 = t(rng.normal(size=(2048, 200)).astype(np.float32))
    idx8k = t(rng.integers(0, 2048, 8192).astype(np.int32))
    s, o = "gather_row_sum", "onehot_gather"
    return [(s, "row5", False, tab32k, key32k, "gather_rows"),
            (s, "misaligned", False, off, idx32k, "gather_rows"),
            (s, "cols200", False, tab200, idx8k, "gather_rows"),
            (o, "row4_k_onehot", True, tab4k, idx32k, "gather_rows"),
            (o, "row8", False, tab2k, idx256, "index_select"),
            (o, "misaligned_bf16", True, off, idx32k, None),
            (o, "cols200", False, tab200, idx8k, "index_select")]


def compare_row_sum_onehot(old_lib, dev, empty):
    """The parent's gather_row_sum and onehot_gather against the row
    walker's, in turns, on the probes' rows 5, 4 (k_onehot) and 8, a
    misaligned view and 200 columns; beside each, an empty kernel launched
    at the new kernel's grid after a torch.empty of the result, and the
    yardstick of the same call (gather_rows at row 4's shape, index_select
    for the float32 one-hot and at 200 columns, gather_rows on the row
    sum's tables)."""
    launch = {"gather_row_sum": old_lib.gather_row_sum_launch,
              "onehot_gather": old_lib.onehot_gather_launch}
    launch["gather_row_sum"].argtypes = [VP, CI, CI, VP, CI, VP, VP]
    launch["onehot_gather"].argtypes = [VP, CI, CI, VP, CI, CI, VP, VP]
    index = torch.cuda.current_device()
    for kind, label, bf16, table, idx, yardstick in row_sum_onehot_cases(dev):
        rows, cols = table.shape
        m = idx.shape[0]
        row_sum = kind == "gather_row_sum"
        shape = (m,) if row_sum else (m, cols)
        flag = () if row_sum else (int(bf16),)
        extra_args = () if row_sum else (bf16,)

        def old(table=table, idx=idx, shape=shape, fn=launch[kind],
                flag=flag):
            out = torch.empty(shape, device=dev)
            _build.launch("old " + kind, fn, index, table.data_ptr(), rows,
                          cols, idx.data_ptr(), *flag, m, out.data_ptr())
            return out

        def new(table=table, idx=idx, fn=getattr(G, kind), a=extra_args):
            return fn(table, idx, *a)

        got, was = new(), old()
        plain = getattr(G, kind + "_plain")(table, idx, *extra_args)
        torch.cuda.synchronize()
        vec = cols % 4 == 0 and table.data_ptr() % 16 == 0
        blocks = walker_blocks(cols, m, vec, 4 if row_sum else 1)

        def floor(shape=shape, blocks=blocks):
            out = torch.empty(shape, device=dev)
            _build.launch("empty", empty, index, out.data_ptr(), blocks, 256)
            return out

        extra = dict(
            shape=[rows, cols, m], bf16=bf16, vector_path=vec,
            new_blocks=blocks, new_equals_plain=torch.equal(got, plain),
            old_equals_new=torch.equal(was, got),
            max_abs_old_new=float((was - got).abs().max()),
            floor_device_us=cs.device_us_total(floor, 50),
            floor_graph_us=cs.graph_time_us(floor)[0])
        if yardstick == "gather_rows":
            def lib(table=table, idx=idx):
                return G.gather_rows(table, idx)
        else:
            def lib(table=table, idx=idx):
                return table.index_select(0, idx)
        if yardstick:
            extra[yardstick + "_device_us"] = cs.device_us_total(lib, 50)
            extra[yardstick + "_graph_us"] = cs.graph_time_us(lib)[0]
        turns(f"{kind} {label}", old, new, 50, graph=True, **extra)
        if not extra["new_equals_plain"] or (
                not row_sum and not extra["old_equals_new"]):
            raise AssertionError(f"{kind} {label}: results differ")


def sweep_gather(dev, empty):
    """csrc/gather.cu built with -D GATHER_THREADS=t for each of
    SWEEP_GATHER_THREADS, on the row sum's and the one-hot's cases and
    gather_rows at row 4, on the misaligned view and per element at row
    6's shape: device us and the
    per-call us of a replayed CUDA graph, each result bit-equal to the plain
    version, and an empty kernel at each build's grid. Every size twice,
    in turns (up, then down)."""
    with ThreadPoolExecutor(len(SWEEP_GATHER_THREADS)) as pool:
        paths = list(pool.map(lambda t: _build.build(
            "gather", {"GATHER_THREADS": t}), SWEEP_GATHER_THREADS))
    libs = {t: ctypes.CDLL(str(path))
            for t, path in zip(SWEEP_GATHER_THREADS, paths)}
    index = torch.cuda.current_device()
    cases = row_sum_onehot_cases(dev)
    by_label = {c[1]: c for c in cases}
    r = "gather_rows"
    rng = np.random.default_rng(1)
    tab8k = torch.as_tensor(rng.normal(size=(8192, 128)).astype(np.float32),
                            device=dev)
    lane = torch.as_tensor(rng.integers(0, 8192, (8192, 128)).astype(
        np.int32), device=dev)
    cases += [(r, "row4", False, *by_label["row4_k_onehot"][3:5], None),
              (r, "misaligned", False, *by_label["misaligned"][3:5], None),
              (r, "row6_per_element", False, tab8k, lane, None)]
    order = SWEEP_GATHER_THREADS + SWEEP_GATHER_THREADS[::-1]
    for kind, label, bf16, table, idx, _ in cases:
        rows, cols = table.shape
        m = idx.shape[0]
        row_sum = kind == "gather_row_sum"
        shape = (m,) if row_sum else (m, cols)
        flag = {"gather_rows": (int(idx.dim() == 2),), "gather_row_sum": (),
                "onehot_gather": (int(bf16),)}[kind]
        plain = (G.onehot_gather_plain(table, idx, bf16)
                 if kind == "onehot_gather"
                 else getattr(G, kind + "_plain")(table, idx))
        vec = cols % 4 == 0 and table.data_ptr() % 16 == 0
        for threads in order:
            fn = getattr(libs[threads], kind + "_launch")
            fn.argtypes = G._ARGTYPES[kind + "_launch"]

            def call(fn=fn, shape=shape, flag=flag):
                out = torch.empty(shape, device=dev)
                _build.launch(kind, fn, index, table.data_ptr(), rows, cols,
                              idx.data_ptr(), *flag, m, out.data_ptr())
                return out
            blocks = walker_blocks(cols, m, vec, 4 if row_sum else 1,
                                   threads)

            def floor(shape=shape, blocks=blocks, threads=threads):
                out = torch.empty(shape, device=dev)
                _build.launch("empty", empty, index, out.data_ptr(), blocks,
                              threads)
                return out
            equal = torch.equal(call(), plain)
            print(json.dumps({
                "sweep": f"{kind} {label}", "threads": threads,
                "blocks": blocks, "vector_path": vec, "bf16": bf16,
                "device_us": cs.device_us_total(call, 50),
                "graph_us": cs.graph_time_us(call)[0],
                "floor_device_us": cs.device_us_total(floor, 50),
                "floor_graph_us": cs.graph_time_us(floor)[0],
                "equal": equal}), flush=True)
            if not equal:
                raise AssertionError(f"{kind} {label} at {threads} threads: "
                                     f"differs from the plain version")


def old_ndt_terms(lib):
    """Commit 00c6537's ndt_terms wrapper around its kernel: per-block
    partials, then the sum, the symmetric gather and the negation on the
    device. Counts its calls in ``launches``, as ``ndt_terms`` does."""
    fn = lib.ndt_terms_launch
    fn.argtypes = [VP, VP, VP, CI, VP, VP, CI, CI, CI, CF, CF, VP, CI, VP]

    def call(slots, rows16, T, gamma, max_corr, dims):
        call.launches += 1
        N._check_inputs(slots, rows16, T, dims)
        inv_2g, maxd2 = N._gate_constants(gamma, max_corr)
        dev = rows16.device
        n = slots.cell.shape[0]
        nb = max(1, -(-n // 256))
        partials = torch.empty((nb, 29), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(slots.points.data_ptr(), slots.cell.data_ptr(),
                    slots.valid.data_ptr(), n, rows16.data_ptr(),
                    T.data_ptr(), dims[0], dims[1], dims[2], inv_2g, maxd2,
                    partials.data_ptr(), nb,
                    torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, rc
        tot = partials.sum(dim=0)
        return tot[:21][N._sym_index(dev)], tot[21:27], -tot[27], tot[28]
    call.launches = 0
    return call


def old_icp_terms(lib):
    """Commit 00c6537's icp_terms wrapper around its kernel."""
    fn = lib.icp_terms_launch
    fn.argtypes = [VP, VP, VP, CI, VP, VP, CI, CI, CI, CI, CF, CF, VP, CI,
                   VP]

    def call(slots, table, T, max_corr, delta, dims, qs, qt):
        I._check_inputs(slots, table, T, dims, qt)
        maxd2, hd = I._gate_constants(max_corr, delta)
        dev = table.device
        n = slots.cell.shape[0]
        nb = max(1, -(-n // 256))
        partials = torch.empty((nb, 30), dtype=torch.float32, device=dev)
        with torch.cuda.device(dev):
            rc = fn(slots.points.data_ptr(), slots.cell.data_ptr(),
                    slots.valid.data_ptr(), n, table.data_ptr(), T.data_ptr(),
                    dims[0], dims[1], dims[2], qt, maxd2, hd,
                    partials.data_ptr(), nb,
                    torch.cuda.current_stream(dev).cuda_stream)
        assert rc == 0, rc
        return I._totals(partials.sum(dim=0))
    return call


def terms_agree(got, old, ref, blocks, count_at):
    """Matched counts exactly equal among new, old and plain; each block of
    new within TERMS_RTOL of the block's largest magnitude in old and in
    plain. Returns (ok, worst relative error against each)."""
    ok = float(got[count_at]) == float(old[count_at]) == float(ref[count_at])
    worst = {}
    for tag, other in (("old", old), ("plain", ref)):
        rel = 0.0
        for (_, a), (_, b) in zip(blocks(got), blocks(other)):
            rel = max(rel, float((a - b).abs().max())
                      / max(float(b.abs().max()), 1e-30))
        worst[tag] = rel
        ok = ok and rel <= TERMS_RTOL
    return ok, worst


def ndt_cases(dev):
    """Config 2's and config 4's odometry terms inputs (fine and wide)."""
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    cases = []
    clouds, gt = cs.city_scans(cs.N_SCANS, dev)
    for label, args in cs.odometry_terms_args(
            DenseLidarOdometry(cs.config2()), clouds, gt):
        cases.append(("c2_" + label, args))
    del clouds
    clouds, gt = cs.config4_scans(dev)
    for label, args in cs.odometry_terms_args(
            DenseLidarOdometry(cs.config4().odometry), clouds, gt):
        cases.append(("c4_" + label, args))
    return cases


def icp_cases(dev):
    """Config 1's coarse and fine stage inputs at 8k and 32k and the probe
    windows."""
    cases, pairs = [], {}
    for n_az, label in ((512, "8k"), (2048, "32k")):
        src, tgt, _ = pairs[label] = cs.config1_pair(dev, n_az)
        r0, _ = cs.raster_register(src, tgt)
        cases.append((f"c1_{label}_coarse", cs.config1_stage_args(
            src, tgt, None, "coarse")))
        cases.append((f"c1_{label}_fine", cs.config1_stage_args(
            src, tgt, r0.T, "fine")))
    for label, args, _ in cs.probe_icp_args(pairs):
        cases.append((label, args))
    return cases


def compare_terms(old_ndt, old_icp, ndt, icp):
    """Old against new in turns on every case; the work counts beside."""
    for label, args in ndt:
        old = old_ndt_terms(old_ndt)
        got, again = N.ndt_terms(*args), N.ndt_terms(*args)
        ok, worst = terms_agree(got, old(*args), N.ndt_terms_plain(*args),
                                cs.terms_blocks, 3)
        ok = ok and all(torch.equal(a, b) for a, b in zip(got, again))
        slots, rows16, T, _, corr, dims = args
        nbytes, flops, counts = cs.terms_work(slots, rows16, T, corr, dims)
        turns(f"ndt_terms {label}", lambda: old(*args),
              lambda: N.ndt_terms(*args), 50, agree=ok,
              rel_err_of_block_max=worst, matched=float(got[3]),
              n_slots=slots.cell.shape[0], bytes=nbytes, flops=flops,
              **counts)
        if not ok:
            raise AssertionError(f"ndt_terms {label}: old and new differ")
    for label, args in icp:
        old = old_icp_terms(old_icp)
        got, again = I.icp_terms_raster(*args), I.icp_terms_raster(*args)
        ok, worst = terms_agree(got, old(*args), I.icp_terms_plain(*args),
                                cs.icp_blocks, 3)
        choice = cs.icp_choice_equal(args)
        ok = ok and choice and all(torch.equal(a, b)
                                   for a, b in zip(got, again))
        slots, table, T, _, _, dims, _, qt = args
        nbytes, flops, counts = cs.icp_work(slots, table, T, dims, qt)
        turns(f"icp_terms {label}", lambda: old(*args),
              lambda: I.icp_terms_raster(*args), 50, agree=ok,
              choice_equal=choice, rel_err_of_block_max=worst,
              nmatch=float(got[3]), n_slots=slots.cell.shape[0],
              bytes=nbytes, flops=flops, **counts)
        if not ok:
            raise AssertionError(f"icp_terms {label}: old and new differ")


def variants(name, key, values):
    """csrc/<name>.cu built with ``-D key=v -D TERMS_MAX_BLOCKS=b`` for each
    v and sweep grid b, all compilers started together: {(v, b): CDLL}."""
    specs = [(v, b) for v in values for b in SWEEP_BLOCKS]
    with ThreadPoolExecutor(len(specs)) as pool:
        paths = list(pool.map(lambda vb: _build.build(name, {
            key: vb[0], "TERMS_MAX_BLOCKS": vb[1]}), specs))
    return {vb: ctypes.CDLL(str(path)) for vb, path in zip(specs, paths)}


def sweep_line(label, fn, matched, want, **fields):
    per, _ = cs.device_time_us(fn, 20)
    print(json.dumps({
        "sweep": label, **fields, "device_us": sum(per.values()),
        "by_kernel": {k[:40]: v for k, v in per.items()},
        "graph_us": cs.graph_time_us(fn)[0],
        "matched_equal": matched == want}), flush=True)
    if matched != want:
        raise AssertionError(f"{label} {fields}: matched {matched} != "
                             f"plain {want}")


def sweep_terms(ndt, icp):
    """Device us and CUDA-graph us a call of other lane splits and grid
    sizes on the main cases, each a -D build of the shipped source."""
    index = torch.cuda.current_device()
    ndt_libs = variants("ndt_terms", "NDT_TERMS_LANES", SWEEP_LANES)
    icp_libs = variants("icp_terms", "ICP_TERMS_LANES", SWEEP_LANES)
    for label, args in ndt:
        if label.startswith("c4"):
            continue
        slots, rows16, T, gamma, corr, dims = args
        consts = N._gate_constants(gamma, corr)
        want = float(N.ndt_terms_plain(*args)[3])
        for (lanes, mb), lib in ndt_libs.items():
            launch = lib.ndt_terms_launch
            launch.argtypes = NDT_ARGTYPES

            def fn(launch=launch, mb=mb):
                out = torch.empty(N.RESULT + N.OUT_CHANNELS * mb,
                                  device=rows16.device)
                _build.launch("ndt_terms", launch, index,
                              slots.points.data_ptr(), slots.cell.data_ptr(),
                              slots.valid.data_ptr(), slots.cell.shape[0],
                              rows16.data_ptr(), T.data_ptr(), *dims,
                              *consts, out.data_ptr())
                return out
            sweep_line(f"ndt_terms {label}", fn, float(fn()[43]), want,
                       lanes=lanes, max_blocks=mb,
                       blocks=N.grid_blocks(slots.cell.shape[0], lanes, mb))
    for label, args in icp:
        if not label.endswith("fine"):
            continue
        slots, table, T, corr, delta, dims, _, qt = args
        consts = I._gate_constants(corr, delta)
        want = float(I.icp_terms_plain(*args)[3])
        # at Qt = 8, 8 lanes is the shipped one lane a target slot
        for (lanes, mb), lib in icp_libs.items():
            launch = lib.icp_terms_launch
            launch.argtypes = ICP_ARGTYPES

            def fn(launch=launch, mb=mb):
                out = torch.empty(I.RESULT + I.OUT_CHANNELS * mb,
                                  device=table.device)
                _build.launch("icp_terms", launch, index,
                              slots.points.data_ptr(), slots.cell.data_ptr(),
                              slots.valid.data_ptr(), slots.cell.shape[0],
                              table.data_ptr(), T.data_ptr(), *dims, qt,
                              *consts, out.data_ptr(), None)
                return out
            sweep_line(f"icp_terms {label}", fn, float(fn()[43]), want,
                       lanes=lanes, max_blocks=mb,
                       blocks=N.grid_blocks(slots.cell.shape[0], lanes, mb))


def slam_orders(old_lib):
    """Config 4 end to end with other summation orders of the NDT sums, each
    kernel in place of the shipped one: one line each with what phase_slam
    measures (it also prints its own), or the limit it missed."""
    import tpu_slam_torch.kernels.ndt_terms as module

    clouds, gt = cs.config4_scans("cuda")
    shipped_launch, shipped_call = module._launch_fn, module.ndt_terms
    runs = [(f"lanes_{v}", {"NDT_TERMS_LANES": v}) for v in (4, 32)]
    runs.append(("blocks_132", {"TERMS_MAX_BLOCKS": 132}))
    runs.append(("old_kernel_00c6537", None))
    for label, defines in runs:
        if defines is None:
            module.ndt_terms = old_ndt_terms(old_lib)
        else:
            lib = ctypes.CDLL(str(_build.build("ndt_terms", defines)))
            module._launch_fn = lib.ndt_terms_launch
            module._launch_fn.argtypes = NDT_ARGTYPES
            module._launch_fn.restype = CI
        try:
            fields = cs.phase_slam(clouds, gt)["fields"]
            line = {k: fields[k] for k in (
                "kf_ate_m", "odometry_ate_m", "loops", "keyframes",
                "ndt_terms_launches", "seconds")}
            error = None
        except AssertionError as e:        # a missed limit is a result here
            line, error = {}, str(e)
        finally:
            module._launch_fn, module.ndt_terms = shipped_launch, shipped_call
        print(json.dumps({"orders": label, "defines": defines, **line,
                          "error": error}), flush=True)


def empty_launch():
    """The bound launch function of an empty kernel: (out, blocks,
    threads, stream)."""
    src = _build.BUILD_DIR / "empty.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(EMPTY_SOURCE)
    fn = build_old(src, "empty").empty_launch
    fn.argtypes = [VP, CI, CI, VP]
    return fn


def empty_floor(dev, fn):
    """Empty kernels launched as the terms wrappers launch theirs (a
    torch.empty of the result, then a ctypes call on the current stream):
    one block, the terms grid's 264 blocks, and 264 blocks followed by one
    block of 1,024 threads (a kernel and its finalizer)."""
    index = torch.cuda.current_device()

    def call(launches):
        out = torch.empty(N.RESULT + 29 * N.MAX_BLOCKS, device=dev)
        for blocks, threads in launches:
            _build.launch("empty", fn, index, out.data_ptr(), blocks,
                          threads)
        return out

    nb = N.MAX_BLOCKS
    for label, launches in (("1_block", ((1, 256),)),
                            (f"{nb}_blocks", ((nb, 256),)),
                            (f"{nb}_blocks_then_1", ((nb, 256), (1, 1024)))):
        per, _ = cs.device_time_us(lambda: call(launches), 50)
        print(json.dumps({
            "empty": label, "device_us": sum(per.values()),
            "wrapper_ms": cs.time_ms(lambda: call(launches), 200),
            "graph_us": cs.graph_time_us(lambda: call(launches))[0],
            "clock": cs.clocks_now()}), flush=True)


def main() -> int:
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    old_dir = pathlib.Path(sys.argv[1])
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line(), flush=True)
    cs.phase_build()
    empty = empty_launch()
    empty_floor(dev, empty)
    if (old_dir / "ndt_terms.cu").exists():
        ndt, icp = ndt_cases(dev), icp_cases(dev)
        old_ndt = build_old(old_dir / "ndt_terms.cu", "ndt_terms")
        compare_terms(old_ndt,
                      build_old(old_dir / "icp_terms.cu", "icp_terms"),
                      ndt, icp)
        if "--sweep" in sys.argv:
            sweep_terms(ndt, icp)
        if "--orders" in sys.argv:
            del ndt, icp
            slam_orders(old_ndt)
    if (old_dir / "nn_search.cu").exists():
        compare_nn(build_old(old_dir / "nn_search.cu", "nn_search"), dev,
                   "--config4" in sys.argv)
    if (old_dir / "gather.cu").exists():
        compare_gather(build_old(old_dir / "gather.cu", "gather"), dev)
    if (old_dir / "gather_3191f90.cu").exists():
        compare_row_sum_onehot(build_old(old_dir / "gather_3191f90.cu",
                                         "gather_3191f90"), dev, empty)
    if "--sweep" in sys.argv:
        sweep_gather(dev, empty)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
