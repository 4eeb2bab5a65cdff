#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: dense odometry (bench config 2),
full SLAM on the dense engine (bench config 4), pair ICP on both tiers
(bench config 1) and the gather probes.

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env          torch / CUDA / nvcc / triton versions and the card
  build        nvcc builds every CUDA source of tpu_slam_torch/csrc, one
               compiler per source, all started together
  kernels      ndt_terms against its plain PyTorch version on the card, at
               the shapes of config 2 (the fine (192, 192, 32) field at
               Q=4, the wide field at Q=8) and on a seeded edge case: two
               calls bit-equal, the call's device events only its kernel
               and finalizer; CUDA-event times, the device time by kernel,
               the time a call takes in a replayed CUDA graph, the bound
  slice        DenseLidarOdometry on config 2 at full width over the
               24-scan city route (65,536 rays a scan): scans/s synced and
               unsynced, ATE, matched fraction, iterations, kernel launches
               per scan, peak memory
  profile      a 6-scan run on the host clock, then under torch.profiler:
               device busy time by kernel, idle share, host syncs and
               kernel launches per step
  determinism  the first 6 scans twice from fresh engines: identical poses
  slam         SLAMSystem(odometry_engine="dense") on config 4 at full
               width: 230 ring-corridor scans (14,400 rays a scan), then the
               final 40-iteration graph refinement; scans/s, optimized-
               keyframe and odometry ATE, loops, keyframes, sweeps, kernel
               launches, wall time by stage, peak memory
  slam_resume  a checkpoint taken after the first sweep that accepts a
               loop, resumed in a fresh SLAMSystem to the end: poses and
               graph bit-identical to the slam run; host syncs and
               launches of a sweep, under torch.profiler
  kernels      nn_search against its plain version: a verification batch
               of the slam run's own keyframes (6 pairs x 4,096 points), a
               seeded edge case (ties, padding, ragged sizes, one pair) and
               a case that the kernel splits across blocks (300 queries,
               200,000 targets, ties on split boundaries); indices equal,
               squared distances bit-equal, times, the split plan, bound
               and 8-instruction floor
  pair_icp     config 1 at 8k, 16k, 32k, 64k, 128k and 256k points: the
               raster tier (icp_raster, coarse then fine call) and the
               brute tier (icp)
               timed as registrations/s by slope_time, recovery errors,
               matched fractions, the tier icp_auto picks, launches, host
               syncs and device idle share a registration
  kernels      icp_terms against its plain version: config 1's coarse and
               fine stage inputs at 8k and 32k, the windows of
               benchmarks/_probe_icp_kernel.py (with the source binning
               timed) and a seeded edge case (ties, cells over capacity,
               the x = 0 and x = Wx-1 planes, padding); nmatch equal and
               every slot's chosen target identical, as for ndt_terms;
               then nn_search on the brute tier's first NN pass at 8k, 64k
               and 128k
  probes       the ports of the three gather probes (tpu_slam_torch/
               benchmarks) at their original sizes, then gather_rows,
               gather_row_sum and onehot_gather against their plain
               versions at the probes' shapes, and gather_rows on a
               misaligned table view and a 7-column table (its scalar
               path): bit-equal, times, bound and the one PyTorch call that
               computes the same function (its ms and device us)

then the script's total seconds, the card's name and power limit
(nvidia-smi), one JSON line with every kernel's numbers, and as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero before the last line.
It needs one CUDA device and nvcc; it imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 non-tensor
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
# instructions issued a second at the 1.98 GHz boost clock: 132 SMs x 4
# schedulers x 32 lanes a cycle; one float32 op a lane a slot (an FMA
# counts once here, twice in FP32_FLOP_PER_S)
FP32_INSTR_PER_S = 132 * 128 * 1.98e9

# Config 2 of bench.py: dense-window odometry on the city route
N_SCANS = 24
WARMUP_SCANS = 3
DETERMINISM_SCANS = 6
ATE_BAR_M = 0.10
MATCHED_BAR = 0.80
# Config 4 of bench.py: full SLAM, two laps of the ring corridor; the bars
# are the reference's result (optimized-keyframe ATE 0.2314 m, 0.23-0.29
# across its runs; 65 loops; 215 keyframes) with room for another float
# summation order
C4_SCANS = 230
C4_KF_ATE_BAR_M = 0.30
C4_MIN_LOOPS = 40
C4_KEYFRAMES = (200, 230)
# Config 1 of bench.py (bench_icp_pair): pair ICP in the default office,
# the source the target moved by exp(C1_XI)^-1. The bars are the
# reference's recovery errors (raster 12.44 mm, brute 11.1 mm at 8k) with
# room for another float summation order
C1_XI = [0.15, -0.1, 0.05, 0.02, -0.02, 0.04]
# azimuths (x 16 rays): the reference's 8k and 32k, and 16k, 64k, 128k and
# 256k to bracket the tiers' crossover on this card
C1_SIZES = ((512, "8k"), (1024, "16k"), (2048, "32k"), (4096, "64k"),
            (8192, "128k"), (16384, "256k"))
C1_RASTER_BAR_MM = 15.0        # at 8k
C1_BRUTE_BAR_MM = 13.0         # at 8k
C1_LARGE_BAR_MM = 20.0         # both tiers at the larger sizes
C1_PERM = (2, 0, 1)            # world z on window x
C1_ORIGIN = (-4.0, -8.0, -8.0)     # (z, x, y)
C1_COARSE = dict(dims=(8, 16, 16), leaf=1.0)
C1_FINE = dict(dims=(16, 32, 32), leaf=0.5)
# slope_time's (K1, K2) per tier and size: the reference's at 8k and 32k
C1_SLOPE_K = {("raster", "8k"): (5, 55), ("brute", "8k"): (3, 23),
              ("raster", "16k"): (3, 23), ("brute", "16k"): (2, 8),
              ("raster", "32k"): (3, 23), ("brute", "32k"): (2, 8),
              ("raster", "64k"): (3, 23), ("brute", "64k"): (2, 8),
              ("raster", "128k"): (3, 23), ("brute", "128k"): (2, 8),
              ("raster", "256k"): (3, 23), ("brute", "256k"): (2, 8)}
# kernel vs plain: each 3x3 block of H, each half of b, and the cost within
# this fraction of that part's own largest magnitude (float32 sums in
# another order); matched count exactly equal, since both round the
# transform and the gate distance op by op
RTOL_OF_MAX = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def clocks_now() -> str:
    """SM clock and its maximum, power draw and temperature, sampled right
    after a kernel's timing loop: times differ between calls of the same
    code, and this says whether the card's clocks differed."""
    return nvidia_smi_line("clocks.sm,clocks.max.sm,power.draw,"
                           "temperature.gpu")


# ---------------------------------------------------------------------------
# Workload: the city route of bench.py (_city_route / _city_scans)
# ---------------------------------------------------------------------------

def city_route(n_poses, step=1.6, turn_radius=8.0):
    """Two street legs along y=-4 then x=-4, joined by a quarter-circle."""
    from tpu_slam_torch.ingest.synthetic import se2_pose

    r = turn_radius
    n_arc = max(1, int(round((math.pi / 2) * r / step)))
    n1 = max(2, (n_poses - n_arc) // 2)
    poses = []
    for k in range(n_poses):
        s = step * k
        s1 = step * (n1 - 1)
        s2 = s1 + (math.pi / 2) * r
        if s <= s1:
            poses.append(se2_pose(-4.0 - r - (s1 - s), -4.0, 0.0, z=1.8))
        elif s <= s2:
            th = (s - s1) / r
            poses.append(se2_pose(-4.0 - r + r * math.sin(th),
                                  -4.0 + r * (1.0 - math.cos(th)), th, z=1.8))
        else:
            poses.append(se2_pose(-4.0, -4.0 + r + (s - s2), math.pi / 2,
                                  z=1.8))
    return poses


def city_scans(n_poses, device, n_azimuth=4096, max_range=75.0, seed=0):
    """VLP-16 revolutions (65,536 rays) along the route in dense_city."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.dense_city(extent=200.0, seed=0)
    rng = np.random.default_rng(seed)
    poses = city_route(n_poses)
    clouds = []
    for T in poses:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, max_range=max_range,
            noise_std=0.01, rng=rng, device=device)
        clouds.append(PointCloud.from_points_host(
            pts[valid], capacity=n_azimuth * 16, device=device))
    return clouds, np.stack(poses)


def config2():
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.registration.ndt import NDTParams

    return OdometryConfig(
        scan_capacity=32768, downsample_leaf=0.3,
        map_leaf=0.5, map_half_extent=128.0, map_capacity=262144,
        scan_max_range=45.0, insert_downsampled=True,
        ndt=NDTParams(max_iterations=10, coarse_iterations=2,
                      tolerance=3e-4, min_voxel_count=3.0,
                      window_dims=(192, 192, 32)),
        pyramid_factor=4, max_pred_translation=2.0)


# ---------------------------------------------------------------------------
# Kernel cases
# ---------------------------------------------------------------------------

def random_terms_case(device, dims=(48, 40, 24), q=4, n=6000, seed=0,
                      leaf=0.5, max_corr=1.0):
    """A seeded field and scan with empty cells, points in window-edge
    cells, one cell holding more than q points, and gate-edge pairs whose
    distance sits within an ulp of max_corr. Returns the ndt_terms args."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster

    rng = np.random.default_rng(seed)
    wx, wy, wz = dims
    g = wx * wy * wz
    cell = np.stack(np.meshgrid(np.arange(wx), np.arange(wy), np.arange(wz),
                                indexing="ij"), -1).reshape(g, 3)
    a = rng.normal(0, 1, (g, 3, 3))
    lam = np.linalg.inv(a @ a.transpose(0, 2, 1) * 0.01 + 0.02 * np.eye(3))
    valid = rng.uniform(size=g) < 0.5                     # empty cells
    rows = np.zeros((g, 16), np.float32)
    rows[:, 0:3] = (cell + 0.5) * leaf + rng.normal(0, 0.08, (g, 3))
    iu = np.triu_indices(3)
    rows[:, 3:9] = lam[:, iu[0], iu[1]]
    rows[:, 9] = valid
    rows[~valid] = 0.0

    ext = np.asarray(dims, np.float64) * leaf
    pts = rng.uniform(-0.2, ext + 0.2, (n, 3)).astype(np.float32)
    pts[:16] = (ext * 0.5 + 0.1).astype(np.float32)       # over q in a cell
    pts[16:40] = rng.uniform(0.0, leaf, (24, 3))          # corner cells
    pts[40:64] = (ext - rng.uniform(0.0, leaf, (24, 3))).astype(np.float32)
    mask = np.ones(n, bool)
    mask[-50:] = False
    pts[-50:] = 1e8
    xi = rng.normal(0, 0.01, 6)
    T = np.eye(4, dtype=np.float32)
    c, s = math.cos(xi[5]), math.sin(xi[5])
    T[:2, :2] = [[c, -s], [s, c]]
    T[:3, 3] = xi[:3]

    # gate-edge pairs: put a valid field mean exactly max_corr (+- a few
    # ulp) from the transformed point, along x, in the point's own cell
    for j, k in enumerate(range(100, 110)):
        x = pts[k].astype(np.float32)
        p = [np.float32(T[r, 0] * x[0]) + np.float32(T[r, 1] * x[1])
             for r in range(3)]
        p = [np.float32(np.float32(p[r] + np.float32(T[r, 2] * x[2]))
                        + T[r, 3]) for r in range(3)]
        cc = np.floor(np.asarray(p) / leaf).astype(int)
        if np.any(cc < 0) or np.any(cc >= np.asarray(dims)):
            continue
        ci = (cc[0] * wy + cc[1]) * wz + cc[2]
        off = np.nextafter(np.float32(max_corr), np.float32(np.inf)) \
            if j % 3 == 0 else (np.float32(max_corr) if j % 3 == 1 else
                                np.nextafter(np.float32(max_corr),
                                             np.float32(0)))
        rows[ci, 0] = np.float32(p[0] - off)
        rows[ci, 1:3] = p[1:3]
        rows[ci, 3:9] = [1.0, 0.0, 0.0, 1.0, 0.0, 1.0]
        rows[ci, 9] = 1.0
    t = lambda x, dt=torch.float32: torch.as_tensor(x, dtype=dt,
                                                    device=device)
    slots, _ = build_terms_raster(t(pts), t(mask, torch.bool), t(T),
                                  t(np.zeros(3)), leaf, dims, q)
    return slots, t(rows), t(T), 4.0, max_corr, dims


def terms_blocks(out):
    """(label, tensor) for each part of an ndt_terms result that is held to
    its own scale: the rotation rows of H and b grow with |p|^2 and |p|,
    the translation rows do not, so one scale for all would hide an error
    in the smaller blocks."""
    H, b, cost = out[:3]
    return [("H_tt", H[:3, :3]), ("H_tr", H[:3, 3:]), ("H_rt", H[3:, :3]),
            ("H_rr", H[3:, 3:]), ("b_t", b[:3]), ("b_r", b[3:]),
            ("cost", cost)]


def terms_work(slots, rows16, T, max_corr, dims):
    """Bytes the terms pass must move and the float32 operations it does
    on this data. Bytes: every slot's valid flag; the point (12) and cell
    (4) of each kept slot; of each field row a kept slot reaches, the valid
    flag (4) alone when the row is empty, else mean, information and flag
    (40); T and the 29 outputs. Flops: 18 a kept slot for the transform and
    ~84 for the 6x6 expansion, 9 a visited valid neighbour (residual +
    gate), 44 more a gated pair (information product, exponent, 11
    accumulators)."""
    import torch

    wx, wy, wz = dims
    g = wx * wy * wz
    v = slots.valid
    x, y, z = slots.points.unbind(1)
    p = [T[r, 0] * x + T[r, 1] * y + T[r, 2] * z + T[r, 3] for r in range(3)]
    c = slots.cell.long()
    cx, cy, cz = c // (wy * wz), (c // wz) % wy, c % wz
    touched, visited, gated = [], 0, 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (v & (nx >= 0) & (nx < wx) & (ny >= 0) & (ny < wy)
                      & (nz >= 0) & (nz < wz))
                nc = torch.clamp((nx * wy + ny) * wz + nz, 0, g - 1)
                touched.append(nc[ok])
                ok = ok & (rows16[nc, 9] > 0.5)
                visited += int(ok.sum())
                r = [p[i] - rows16[nc, i] for i in range(3)]
                de2 = r[0] * r[0] + r[1] * r[1] + r[2] * r[2]
                gated += int((ok & (de2 < max_corr ** 2)).sum())
    rows_hit = torch.unique(torch.cat(touched))
    n_rows = int(rows_hit.numel())
    n_full = int((rows16[rows_hit, 9] > 0.5).sum())
    n = slots.cell.shape[0]
    n_valid = int(v.sum())
    nbytes = (n + n_valid * (12 + 4) + n_full * 40 + (n_rows - n_full) * 4
              + 64 + 29 * 4)
    flops = n_valid * (18 + 84) + visited * 9 + gated * 44
    return nbytes, flops, dict(slots=n_valid, touched_rows=n_rows,
                               touched_valid_rows=n_full,
                               visited_pairs=visited, gated_pairs=gated)


def time_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_us(fn, reps):
    """Per-call device time by kernel name, from torch.profiler (us).

    Only the device's own events count (kernels, copies, fills): a CPU op's
    "self device time" is the time of the kernels it launched, which are
    listed again under their own names. The profiler on the card can drop
    a kernel's events (it has reported a fifth of a kernel's launches), so
    each name's time is its mean over the events seen times the launches
    a call makes (its count over ``reps``, at least one)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a profiled cycle can come back without device events, or with some
    # dropped; profile up to four times more
    for _ in range(5):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out, whole = {}, True
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
                per_call = max(1, round(e.count / reps))
                out[e.key] = e.self_device_time_total / e.count * per_call
                whole = whole and e.count % reps == 0
        if out and whole:
            break
    return out, prof


def graph_time_us(fn, calls=20, replays=10):
    """Device time of one call of ``fn`` when ``calls`` calls are captured
    in a CUDA graph and replayed (CUDA events over the replays): what a
    captured loop pays a call, launch gaps included. None, with the error,
    if the capture fails."""
    import torch

    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(replays):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) * 1e3 / (calls * replays), None
    except RuntimeError as e:        # measurement only: report, go on
        torch.cuda.synchronize()
        return None, str(e)[:200]


def check_sums_case(name, kernel, plain, args, blocks, count_at, work,
                    names, build=None):
    """A reduction kernel (NDT or ICP terms) vs its plain version on one
    case: each part of ``blocks(out)`` within RTOL_OF_MAX of its own
    largest magnitude, the matched count ``out[count_at]`` exactly equal
    and above 0, two calls bit-equal; times, the bound from ``work`` =
    (bytes, flops, counts), and the source binning ``build`` timed beside
    the pass if given. Every device event of a call must be one of the
    kernel's own ``names`` (its kernel and finalizer): the wrapper runs no
    other device work."""
    import torch

    label0 = f"{kernel.__name__} {name}"
    got = kernel(*args)
    again = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{label0}: two calls differ")
    errs, rel = [], {}
    for (label, a), (_, b) in zip(blocks(got), blocks(ref)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not err <= RTOL_OF_MAX * max(scale, 1e-30):
            raise AssertionError(f"{label0}: {label} off by {err} "
                                 f"(scale {scale})")
        errs.append(err)
        rel[label] = err / max(scale, 1e-30)
    if float(got[count_at]) != float(ref[count_at]):
        raise AssertionError(f"{label0}: matched {float(got[count_at])} "
                             f"!= plain {float(ref[count_at])}")
    if not float(ref[count_at]) > 0:
        raise AssertionError(f"{label0}: nothing matched")
    ms = time_ms(lambda: kernel(*args), 50)
    clocks = clocks_now()
    plain_ms = time_ms(lambda: plain(*args), 5)
    # the event time above includes the wrapper's host work when that is
    # longer than the device work; the profiler splits out the kernels
    per_kernel, _ = device_time_us(lambda: kernel(*args), 20)
    foreign = [k for k in per_kernel if not any(n in k for n in names)]
    if foreign:
        raise AssertionError(f"{label0}: device work besides the kernel: "
                             f"{foreign}")
    graph_us, graph_error = graph_time_us(lambda: kernel(*args))
    nbytes, flops, counts = work
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    extra = {} if build is None else dict(build_ms=time_ms(build, 20))
    if graph_error:
        extra["graph_error"] = graph_error
    return dict(case=name, n_slots=args[0].cell.shape[0],
                matched=float(got[count_at]), max_abs_err=max(errs),
                rel_err_of_block_max=rel, ms=ms, plain_ms=plain_ms,
                kernel_device_us=sum(per_kernel.values()) or None,
                device_events={k[:60]: t for k, t in per_kernel.items()},
                graph_us_per_call=graph_us,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, clocks_after_timing=clocks,
                **counts, **extra)


def check_terms_case(name, args):
    """ndt_terms vs its plain version on one case."""
    from tpu_slam_torch.kernels.ndt_terms import (KERNEL_NAMES, ndt_terms,
                                                  ndt_terms_plain)

    slots, rows16, T, _, max_corr, dims = args
    return dict(check_sums_case(name, ndt_terms, ndt_terms_plain, args,
                                terms_blocks, 3,
                                terms_work(slots, rows16, T, max_corr, dims),
                                KERNEL_NAMES), dims=list(dims))


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_env():
    import torch

    from tpu_slam_torch.kernels import _build
    out = subprocess.run([_build.nvcc_path(), "--version"],
                         capture_output=True, text=True, timeout=60)
    nvcc = out.stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, triton=triton_version, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0),
         device_count=torch.cuda.device_count(),
         nvidia_smi=nvidia_smi_line())


def phase_build():
    """One nvcc per source, all started together, then load each."""
    from concurrent.futures import ThreadPoolExecutor

    from tpu_slam_torch.kernels import _build

    sources = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        for fut in [pool.submit(_build.build, name) for name in sources]:
            fut.result()
    for name in sources:
        _build.load(name)
    paths = [_build.library_path(name) for name in sources]
    ptxas = {p.stem: [ln.strip() for ln in
                      p.with_suffix(".ptxas.txt").read_text().splitlines()
                      if "registers" in ln or "spill" in ln]
             for p in paths if p.with_suffix(".ptxas.txt").exists()}
    emit("build", sources=sources, seconds=time.perf_counter() - t0,
         ptxas=ptxas)


def odometry_terms_args(engine, clouds, gt):
    """The terms pass's inputs on an odometry engine's main path: the
    engine warmed on the first scans, then the next scan binned at the
    predicted pose into the fine field (``fine``, Q = raster_q) and the
    wide field (``wide``, the coarse stage's Q), scored at a pose 2 cm off.
    Returns [(label, args)] for ndt_terms."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.kernels.downsample import voxel_downsample
    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster
    from tpu_slam_torch.mapping.dense_map import grid_ndt_field

    cfg = engine.config
    state = engine.init_state(clouds[0], gt[0])
    for k in range(1, WARMUP_SCANS):
        state = engine.step(state, clouds[k])
    cloud = clouds[WARMUP_SCANS]
    T0 = state.pose @ state.last_delta
    T = se3.retract(T0, torch.tensor([0.02, -0.01, 0.0, 0.0, 0.0, 0.005],
                                     device=engine.device))
    dev = engine.device

    def window_origin(grid, spec):
        return spec.origin_tensor(dev) + grid.origin_cell.float() * spec.leaf

    fine = grid_ndt_field(state.grid, engine.map_spec,
                          min_voxel_count=cfg.ndt.min_voxel_count,
                          evec_floor_ratio=cfg.ndt.evec_floor_ratio)
    scan = engine.downsample(cloud)
    slots, _ = build_terms_raster(
        scan.points, scan.mask, T0, window_origin(state.grid, engine.map_spec),
        engine.map_spec.leaf, engine.dims, cfg.ndt.raster_q)
    cases = [(f"fine_q{cfg.ndt.raster_q}",
              (slots, fine.rows, T, cfg.ndt.score_temperature,
               cfg.ndt.max_corr_dist, engine.dims))]

    cp = engine.coarse_params
    wide = grid_ndt_field(state.wide, engine.coarse_spec,
                          min_voxel_count=cfg.ndt.min_voxel_count,
                          evec_floor_ratio=cfg.ndt.evec_floor_ratio)
    cscan = voxel_downsample(cloud, engine.coarse_scan_spec,
                             capacity=engine.coarse_scan_capacity)
    cslots, _ = build_terms_raster(
        cscan.points, cscan.mask, T0,
        window_origin(state.wide, engine.coarse_spec),
        engine.coarse_spec.leaf, engine.dims, cp.raster_q)
    cases.append((f"wide_q{cp.raster_q}",
                  (cslots, wide.rows, T,
                   cp.score_temperature * cp.coarse_temperature_scale,
                   cp.max_corr_dist, engine.dims)))
    return cases


def phase_kernels(engine, clouds, gt):
    """Warm the engine on the first scans, then hold the kernel against its
    plain version on the main path's own inputs."""
    cases = [check_terms_case(label, args) for label, args in
             odometry_terms_args(engine, clouds, gt)]
    cases.append(check_terms_case("edges", random_terms_case(
        engine.device)))
    emit("kernels", kernels=["ndt_terms"], cases=cases,
         rtol_of_max=RTOL_OF_MAX)
    return cases


def phase_slice(engine, clouds, gt):
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.pipeline.metrics import MetricsLog, ate_rmse

    engine.metrics = MetricsLog()
    plain_before = ndt_terms_plain.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ndt_terms.launches = 0
    t0 = time.perf_counter()
    poses, log = engine.run(clouds, init_pose=gt[0])
    dt = time.perf_counter() - t0
    launches = ndt_terms.launches
    peak = torch.cuda.max_memory_allocated()
    if launches <= 0:
        raise AssertionError("the main path launched no ndt_terms kernel")
    if ndt_terms_plain.launches != plain_before:
        raise AssertionError("the main path ran the plain terms version")

    summary = log.summary()
    ate = ate_rmse(poses, gt, align=False)
    if poses.shape != (N_SCANS, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError("poses are not finite (N, 4, 4)")
    R = poses[:, :3, :3]
    ortho = float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())
    if ortho > 1e-4:
        raise AssertionError(f"rotations drifted off SO(3): {ortho}")
    if not ate <= ATE_BAR_M:
        raise AssertionError(f"ATE {ate} m above {ATE_BAR_M} m")
    if not summary["mean_matched_fraction"] >= MATCHED_BAR:
        raise AssertionError(f"matched fraction "
                             f"{summary['mean_matched_fraction']} below "
                             f"{MATCHED_BAR}")

    engine.metrics = MetricsLog()
    t0 = time.perf_counter()
    poses_async, _ = engine.run(clouds, init_pose=gt[0], sync_every=0)
    dt_async = time.perf_counter() - t0
    steps = N_SCANS - 1
    emit("slice", scans=N_SCANS, rays_per_scan=int(clouds[0].capacity),
         window=list(engine.dims), scans_per_s=N_SCANS / dt,
         scans_per_s_sync_every_0=N_SCANS / dt_async,
         ate_m=ate, ate_m_sync_every_0=ate_rmse(poses_async, gt,
                                                 align=False),
         mean_matched_fraction=summary["mean_matched_fraction"],
         mean_iterations=summary["mean_iterations"],
         p50_step_s=summary["p50_wall_time_s"],
         p95_step_s=summary["p95_wall_time_s"],
         ndt_terms_launches=launches,
         ndt_terms_launches_per_step=launches / steps,
         peak_memory_bytes=peak, rotation_orthonormality_err=ortho)
    return launches


def phase_profile(engine, clouds, gt, n=6):
    """Where a step's time goes: an n-scan run (sync_every=0) timed on the
    host clock, then the same run under torch.profiler for the device's
    busy time by kernel. The idle share is 1 - busy / unprofiled wall."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import KERNEL_NAMES
    from tpu_slam_torch.pipeline.metrics import MetricsLog

    def run():
        engine.metrics = MetricsLog()
        engine.run(clouds[:n], init_pose=gt[0], sync_every=0)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()                        # returns host poses, so it ends synced
    wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel, prof = device_time_us(run, 1)
    steps = n - 1
    ka = prof.key_averages()
    busy_us = sum(per_kernel.values())
    terms_us = sum(t for k, t in per_kernel.items()
                   if any(n in k for n in KERNEL_NAMES))
    top_dev = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:10]
    top_cpu = sorted(((e.key, e.self_cpu_time_total, e.count) for e in ka),
                     key=lambda r: -r[1])[:10]
    syncs = sum(e.count for e in ka if e.key == "aten::_local_scalar_dense")
    launches = sum(e.count for e in ka if e.key == "cudaLaunchKernel")
    emit("profile", scans=n, steps=steps,
         wall_ms_per_step=wall_us / 1e3 / steps,
         device_busy_ms_per_step=busy_us / 1e3 / steps,
         ndt_terms_kernel_ms_per_step=terms_us / 1e3 / steps,
         device_idle_share=1.0 - busy_us / wall_us,
         host_syncs_per_step=syncs / steps,
         kernel_launches_per_step=launches / steps,
         top_device_us_per_step=[(k[:80], v / steps) for k, v in top_dev],
         top_cpu_us_per_step=[(k[:80], t / steps, c / steps)
                              for k, t, c in top_cpu])


def phase_determinism(clouds, gt):
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    runs = [DenseLidarOdometry(config2()).run(
        clouds[:DETERMINISM_SCANS], init_pose=gt[0], sync_every=0)[0]
        for _ in range(2)]
    if not np.array_equal(runs[0], runs[1]):
        raise AssertionError("reruns differ: max "
                             f"{np.abs(runs[0] - runs[1]).max()}")
    emit("determinism", scans=DETERMINISM_SCANS, bit_identical=True)


# ---------------------------------------------------------------------------
# Config 4: full SLAM on the dense engine (bench.py:607-743)
# ---------------------------------------------------------------------------

def config4_scans(device, n_poses=C4_SCANS):
    """Two ring-corridor laps (bench.py _config4_workload): 900 azimuths x
    16 rings to 20 m, 2 cm range noise from default_rng(0)."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.ring_corridor()
    gt = syn.corridor_route(n_poses, step=0.6, speed_var=0.35)
    rng = np.random.default_rng(0)
    clouds = []
    for T in gt:
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=900, max_range=20.0, noise_std=0.02,
            rng=rng, device=device)
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=16384,
                                                  device=device))
    return clouds, gt


def config4():
    """bench.py _config4_cfg, field for field."""
    from tpu_slam_torch.graph.loop_closure import LoopClosureParams
    from tpu_slam_torch.graph.pose_graph import GraphSolveParams
    from tpu_slam_torch.pipeline.config import OdometryConfig, SLAMConfig
    from tpu_slam_torch.registration.icp import ICPParams
    from tpu_slam_torch.registration.ndt import NDTParams

    return SLAMConfig(
        odometry=OdometryConfig(scan_capacity=8192, downsample_leaf=0.25,
                                map_leaf=0.5, map_half_extent=32.0,
                                map_capacity=32768, insert_downsampled=True,
                                ndt=NDTParams(max_iterations=12,
                                              coarse_iterations=2,
                                              min_voxel_count=3.0,
                                              window_dims=(32, 32, 16)),
                                pyramid_factor=2),
        odometry_engine="dense",
        reanchor_after_loop=False, rebuild_map_after_loop=False,
        keyframe_translation=0.4, keyframe_rotation=0.12,
        keyframe_capacity=288, keyframe_cloud_capacity=4096, loop_every=4,
        loop=LoopClosureParams(
            max_distance=2.0, min_index_gap=60, max_candidates=6,
            max_error=0.05, min_matched_fraction=0.85,
            max_correction_t=2.5, max_correction_r=0.6,
            icp=ICPParams(max_iterations=40, tolerance=5e-4,
                          max_corr_dist=2.0, huber_delta=0.3)),
        edge_capacity=1024,
        graph=GraphSolveParams(gn_iterations=12, cg_iterations=200,
                               robust_delta=0.3, robust_kernel="cauchy",
                               trust_loops=True),
        loop_edge_info=400.0)


# bench.py:722-727: keyframes appended after the last accepted loop have
# never been optimized (loosely coupled), so one final batch refinement
def final_refine(graph):
    from tpu_slam_torch.graph.pose_graph import (GraphSolveParams,
                                                 optimize_pose_graph)

    return optimize_pose_graph(graph, GraphSolveParams(
        gn_iterations=40, cg_iterations=800, robust_delta=0.15,
        robust_kernel="cauchy", trust_loops=True))[0]


def is_sweep(cfg, state, m) -> bool:
    """Whether the step that produced (state, m) ran a loop sweep."""
    n = state.n_keyframes
    return bool(m.is_keyframe and n % cfg.loop_every == 0
                and n > cfg.loop.min_index_gap)


def phase_slam(clouds, gt):
    """Config 4 end to end, as bench_full_slam measures it; keeps a host
    snapshot of the state after the first sweep that accepts a loop."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    cfg = config4()
    slam = SLAMSystem(cfg)
    plain_before = (nearest_neighbors_plain.launches,
                    ndt_terms_plain.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    nearest_neighbors.launches = 0
    ndt_terms.launches = 0
    t0 = time.perf_counter()
    state = slam.init_state(gt[0])
    poses, kf_scan, snap, sweeps, snap_s = [], [], None, 0, 0.0
    for k, c in enumerate(clouds):
        loops_before = state.n_loop_closures
        state, m = slam.step(state, c)
        poses.append(state.odom.pose.cpu().numpy())
        if len(kf_scan) < state.n_keyframes:
            kf_scan.append(k)
        sweeps += is_sweep(cfg, state, m)
        if snap is None and state.n_loop_closures > loops_before:
            ts = time.perf_counter()
            snap = (k + 1, slam_state_to_numpy(state))
            snap_s = time.perf_counter() - ts
    torch.cuda.synchronize()
    t_refine = time.perf_counter()
    graph = final_refine(state.graph)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t_refine
    # the snapshot for slam_resume is not part of the workload
    dt = time.perf_counter() - t0 - snap_s
    nn_launches = nearest_neighbors.launches
    terms_launches = ndt_terms.launches
    peak = torch.cuda.max_memory_allocated()
    plain_after = (nearest_neighbors_plain.launches,
                   ndt_terms_plain.launches)
    poses = np.stack(poses)
    n = state.n_keyframes
    kf_poses = graph.poses[:n].cpu().numpy()
    if not (np.all(np.isfinite(poses)) and np.all(np.isfinite(kf_poses))):
        raise AssertionError("non-finite poses")
    kf_ate = ate_rmse(kf_poses, gt[np.asarray(kf_scan[:n])], align=False)
    odom_ate = ate_rmse(poses, gt, align=False)
    stages = dict(slam.stage_seconds)
    fields = dict(
        scans=len(clouds), rays_per_scan=900 * 16, seconds=dt,
        scans_per_s=len(clouds) / dt, kf_ate_m=kf_ate, odometry_ate_m=odom_ate,
        loops=state.n_loop_closures, keyframes=n, sweeps=sweeps,
        nn_search_launches=nn_launches, ndt_terms_launches=terms_launches,
        stage_seconds=stages, final_refine_seconds=refine_s,
        other_seconds=dt - sum(stages.values()) - refine_s,
        first_accepting_sweep_after_scan=None if snap is None else snap[0],
        peak_memory_bytes=peak)
    emit("slam", **fields)
    if plain_after != plain_before:
        raise AssertionError("the SLAM path ran a plain kernel version")
    if nn_launches <= 0 or terms_launches <= 0:
        raise AssertionError("the SLAM path launched no nn_search or no "
                             "ndt_terms kernel")
    if not kf_ate <= C4_KF_ATE_BAR_M:
        raise AssertionError(f"optimized-keyframe ATE {kf_ate} m above "
                             f"{C4_KF_ATE_BAR_M} m")
    if state.n_loop_closures < C4_MIN_LOOPS:
        raise AssertionError(f"{state.n_loop_closures} loops, under "
                             f"{C4_MIN_LOOPS}")
    if not C4_KEYFRAMES[0] <= n <= C4_KEYFRAMES[1]:
        raise AssertionError(f"{n} keyframes outside {C4_KEYFRAMES}")
    if snap is None:
        raise AssertionError("no sweep accepted a loop")
    return dict(poses=poses, state=state, graph=graph, snap=snap,
                nn_launches=nn_launches, fields=fields)


def profile_step(slam, state, cloud):
    """One SLAM step under torch.profiler: (state, m, counts) with the
    step's device->host copies, explicit device synchronisations, kernel
    launches and nn_search device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state, m = slam.step(state, cloud)
        torch.cuda.synchronize()
    ka = prof.key_averages()

    def count(pred):
        return sum(e.count for e in ka if pred(e.key))

    nn_us = sum(e.self_device_time_total for e in ka
                if e.device_type == DeviceType.CUDA
                and "nn_search_kernel" in e.key)
    return state, m, dict(
        dtoh_copies=count(lambda k: "Memcpy DtoH" in k),
        device_synchronize=count(lambda k: k == "cudaDeviceSynchronize"),
        kernel_launches=count(lambda k: k in ("cudaLaunchKernel",
                                              "cuLaunchKernel",
                                              "cuLaunchKernelEx")),
        nn_search_device_us=nn_us)


def phase_slam_resume(run, clouds, tmpdir):
    """Save the snapshot as a checkpoint, resume it in a fresh system, run
    to the end: every pose and the final graph must equal the slam run's
    bit for bit. The first sweep after the resume point and the step
    before it run under the profiler, for the sweep's syncs and launches."""
    import os

    import torch

    from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.pipeline.state import slam_state_from_numpy

    cfg = config4()
    k0, snap = run["snap"]
    dims = cfg.odometry.ndt.window_dims
    dev = run["state"].kf_points.device
    path = save_checkpoint(os.path.join(tmpdir, "config4"),
                           slam_state_from_numpy(snap, dims, dev),
                           scan_index=k0)
    state, manifest = load_checkpoint(path, device=dev)
    slam = SLAMSystem(cfg, device=dev)
    poses, prev, sweep = [], None, None
    for k in range(k0, len(clouds)):
        # profile steps until one sweeps and accepts a loop; keep the last
        # keyframe step without a sweep before it
        if sweep is None:
            loops0 = state.n_loop_closures
            state, m, counts = profile_step(slam, state, clouds[k])
            if is_sweep(cfg, state, m):
                if state.n_loop_closures > loops0:
                    sweep = counts
            elif m.is_keyframe:
                prev = counts
        else:
            state, _ = slam.step(state, clouds[k])
        poses.append(state.odom.pose.cpu().numpy())
    graph = final_refine(state.graph)
    torch.cuda.synchronize()
    same_poses = np.array_equal(np.stack(poses), run["poses"][k0:])
    same_graph = all(torch.equal(getattr(graph, f), getattr(run["graph"], f))
                     for f in ("poses", "edge_i", "edge_j", "edge_T",
                               "edge_info", "edge_mask"))
    if not (same_poses and same_graph
            and state.n_loop_closures == run["state"].n_loop_closures):
        raise AssertionError(f"resumed run differs: poses {same_poses}, "
                             f"graph {same_graph}")
    sweep_cost = None
    if sweep is not None and prev is not None:
        sweep_cost = {k: sweep[k] - prev[k] for k in sweep}
    emit("slam_resume", resumed_after_scan=k0, scans_resumed=len(poses),
         checkpoint_bytes=os.path.getsize(path), manifest=manifest,
         bit_identical=True, sweep_step_profile=sweep,
         keyframe_step_profile=prev, sweep_minus_keyframe_step=sweep_cost)


def nn_work(q, t, q_mask, t_mask):
    """Bytes and float32 operations the NN function needs on this data:
    each valid query against each valid target (3 sub, 3 mul, 2 add);
    valid points read once (12 B), an index and a distance written per
    valid query."""
    nq = q_mask.sum(dim=-1).double()
    nt = t_mask.sum(dim=-1).double()
    flops = int((nq * nt).sum()) * 8
    nbytes = int(nq.sum() + nt.sum()) * 12 + int(nq.sum()) * 8
    return nbytes, flops


NN_KERNELS = ("nn_search_kernel", "nn_search_merge_kernel")
# above this many query-target pairs the one cdist call that computes the
# same function would hold the whole (N, M) matrix (17 GB at config 1's
# 64k, 69 GB at 128k) and take seconds: no library time there
NN_LIBRARY_MAX_PAIRS = 1 << 30


def device_us_total(fn, reps):
    """Device us of one call, every device event (from the profiler): a
    library call's, to set beside a kernel's."""
    per_kernel, _ = device_time_us(fn, reps)
    return sum(per_kernel.values()) or None


def check_nn_case(name, q, t, q_mask, t_mask):
    """Kernel vs plain on one case: indices equal and squared distances
    bit-equal on every query (padding queries included); times, the split
    plan and the bound."""
    import torch

    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain,
                                                  split_plan)

    gi, g2 = nearest_neighbors(q, t, squared=True)
    pi, p2 = nearest_neighbors_plain(q, t, squared=True)
    torch.cuda.synchronize()
    if not torch.equal(gi, pi):
        bad = int((gi != pi).sum())
        raise AssertionError(f"nn_search {name}: {bad} indices differ")
    if not torch.equal(g2, p2):
        raise AssertionError(f"nn_search {name}: squared distances differ "
                             f"by {float((g2 - p2).abs().max())}")
    gd = nearest_neighbors(q, t)[1]
    pd = nearest_neighbors_plain(q, t)[1]
    err = float((gd - pd).abs().max())
    ms = time_ms(lambda: nearest_neighbors(q, t), 20)
    clocks = clocks_now()
    plain_ms = time_ms(lambda: nearest_neighbors_plain(q, t), 3)
    library_ms = library_us = None
    if q.shape[-2] * t.shape[-2] <= NN_LIBRARY_MAX_PAIRS:
        def library():
            return torch.cdist(
                q, t, compute_mode="donot_use_mm_for_euclid_dist").min(-1)

        library_ms = time_ms(library, 5)
        library_us = device_us_total(library, 5)
    per_kernel, _ = device_time_us(lambda: nearest_neighbors(q, t), 10)
    kernel_us = sum(v for k, v in per_kernel.items()
                    if any(n in k for n in NN_KERNELS))
    nbytes, flops = nn_work(q, t, q_mask, t_mask)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    b = q.shape[0] if q.dim() == 3 else 1
    splits, chunk = split_plan(b, q.shape[-2], t.shape[-2])
    return dict(case=name, shape=[list(q.shape), list(t.shape)],
                valid_queries=int(q_mask.sum()),
                valid_targets=int(t_mask.sum()), max_abs_err=err,
                splits=splits, chunk=chunk,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                library_device_us=library_us,
                kernel_device_us=kernel_us or None,
                device_us_by_kernel=sorted(
                    ((k[:60], v) for k, v in per_kernel.items()),
                    key=lambda kv: -kv[1])[:4],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                # 8 issue slots a valid pair (the 8 rounded float ops,
                # which cannot fuse) over 132 SMs x 128 lanes x 1.98 GHz
                floor_8_instr_ms=flops / FP32_INSTR_PER_S * 1e3,
                bytes=nbytes, flops=flops, clocks_after_timing=clocks)


def nn_edge_case(device, seed=0):
    """One pair, ragged sizes (1,000 x 1,537), padding on both sides, exact
    duplicate targets (distance ties) and queries on them."""
    import torch

    rng = np.random.default_rng(seed)
    n, m = 1000, 1537
    t = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    t[1400:1420] = t[0:20]                 # later duplicates: ties
    q[:20] = t[:20]                        # queries on the tied targets
    q[20:40] = t[:20] + np.float32(0.01)
    t_mask = np.ones(m, bool)
    t_mask[-37:] = False
    t[-37:] = 1e8
    q_mask = np.ones(n, bool)
    q_mask[-50:] = False
    q[-50:] = 1e8
    g = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return g(q), g(t), g(q_mask), g(t_mask)


def nn_split_case(device, seed=0, n=300, m=200_000):
    """One pair of few queries and many targets, so the kernel's plan cuts
    the targets into splits: exact duplicate targets on both sides of
    split boundaries (t[c*chunk] = t[c*chunk - 1]) and across splits
    (t[c*chunk + 1] = t[5]), queries on them and 0.01 m off them, padding
    targets at the end."""
    import torch

    from tpu_slam_torch.kernels.nn_search import split_plan

    splits, chunk = split_plan(1, n, m)
    if splits < 4:
        raise AssertionError(f"nn split case: only {splits} splits")
    rng = np.random.default_rng(seed)
    t = rng.uniform(-10, 10, (m, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    k = 0
    for c in (1, 2, splits // 2, splits - 1):
        lo = c * chunk
        t[lo] = t[lo - 1]
        t[lo + 1] = t[5]
        for src in (lo - 1, 5):
            q[k], q[k + 1] = t[src], t[src] + np.float32(0.01)
            k += 2
    t_mask = np.ones(m, bool)
    t_mask[-100:] = False
    t[-100:] = 1e8
    q_mask = np.ones(n, bool)
    q_mask[-10:] = False
    q[-10:] = 1e8
    g = lambda x: torch.as_tensor(x, device=device)  # noqa: E731
    return g(q), g(t), g(q_mask), g(t_mask)


def verification_batch(state, cfg, n_pairs=6):
    """The first ICP iteration's NN inputs of a verification batch from the
    slam run's keyframes: the accepted loop pairs (i, j), source cloud j
    moved by the initial guess T_i^-1 T_j, target cloud i."""
    import torch

    from tpu_slam_torch.core import se3

    pairs = sorted(state.loop_pairs)[:n_pairs]
    dev = state.kf_points.device
    ci = torch.as_tensor([p[0] for p in pairs], device=dev)
    cj = torch.as_tensor([p[1] for p in pairs], device=dev)
    poses = state.graph.poses
    init = se3.inverse(poses[ci]) @ poses[cj]
    src = state.kf_points[cj]
    q = torch.where(state.kf_mask[cj][..., None], se3.apply(init, src), 1e8)
    t = torch.where(state.kf_mask[ci][..., None], state.kf_points[ci], 1e8)
    return (q.contiguous(), t.contiguous(), state.kf_mask[cj],
            state.kf_mask[ci])


def phase_nn_kernels(run):
    dev = run["state"].kf_points.device
    cases = [check_nn_case("config4_verify",
                           *verification_batch(run["state"], config4())),
             check_nn_case("edges", *nn_edge_case(dev)),
             check_nn_case("split_ties_300_x_200k", *nn_split_case(dev))]
    emit("kernels", kernels=["nn_search"], cases=cases,
         check="indices equal, squared distances bit-equal")
    return cases


# ---------------------------------------------------------------------------
# Config 1: pair ICP, raster and brute tiers (bench.py:158-276)
# ---------------------------------------------------------------------------

def config1_pair(device, n_azimuth):
    """(source, target, xi): one VLP-16 revolution in the default office
    from z = 1.5 m, and the same cloud moved by exp(xi)^-1."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    T0 = np.eye(4)
    T0[:3, 3] = [0, 0, 1.5]
    pts, valid = syn.simulate_vlp16_revolution(
        syn.default_office(), T0, n_azimuth=n_azimuth, device=device)
    tgt = PointCloud.from_points_host(pts[valid], capacity=n_azimuth * 16,
                                      device=device)
    xi = torch.tensor(C1_XI, dtype=torch.float32, device=device)
    return tgt.transform(se3.inverse(se3.exp(xi))), tgt, xi


def config1_params():
    """(brute, coarse raster, fine raster) ICPParams of bench_icp_pair."""
    import dataclasses

    from tpu_slam_torch.registration.icp import ICPParams

    params = ICPParams(max_iterations=30, max_corr_dist=1.5)
    return (params,
            dataclasses.replace(params, max_iterations=8, tolerance=1e-3),
            dataclasses.replace(params, max_iterations=8, tolerance=5e-4))


def raster_register(src, tgt, init_T=None):
    """The raster tier of config 1: a coarse call (leaf 1.0), then a fine
    call (leaf 0.5) from its result, both with world z on window x.
    Returns (coarse result, fine result)."""
    import torch

    from tpu_slam_torch.registration.icp import icp_raster

    _, coarse, fine = config1_params()
    origin = torch.tensor(C1_ORIGIN, device=src.points.device)
    r0 = icp_raster(src, tgt, init_T=init_T, params=coarse,
                    origin_world=origin, axis_perm=C1_PERM, **C1_COARSE)
    return r0, icp_raster(src, tgt, init_T=r0.T, params=fine,
                          origin_world=origin, axis_perm=C1_PERM, **C1_FINE)


def brute_register(src, tgt, init_T=None):
    from tpu_slam_torch.registration.icp import icp

    return icp(src, tgt, init_T=init_T, params=config1_params()[0])


def registration_loop(register, device):
    """bench_icp_pair's timed loop: K registrations, each started from the
    last result moved by sin(i) * 0.05 in x, so every one depends on the
    one before; returns a scalar that depends on all of them."""
    import torch

    def run(k):
        Tc = torch.eye(4, device=device)
        acc = torch.zeros((), device=device)
        for i in range(k):
            Ti = Tc.clone()
            Ti[0, 3] += math.sin(i) * 0.05
            r = register(Ti)
            Tc, acc = r.T, acc + r.error
        return Tc[0, 3] + acc

    return run


def recovery_err_mm(xi, T):
    from tpu_slam_torch.core import se3

    return float(se3.log(se3.inverse(se3.exp(xi)) @ T).norm()) * 1e3


def registration_profile(fn, counter):
    """One call of ``fn`` on the host clock, then the same call under
    torch.profiler: kernel launches, host syncs (device-to-host scalar
    reads; host-to-device copies from pageable memory, which wait for the
    stream too), device busy time, the device's idle share of the
    unprofiled call, the host ops that take the most CPU time, and how far
    ``counter()`` (a kernel's launch count) moved in the profiled call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    before = counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    top_cpu = sorted(((e.key[:60], e.self_cpu_time_total, e.count)
                      for e in ka if e.device_type == DeviceType.CPU),
                     key=lambda r: -r[1])[:8]
    busy_us = sum(e.self_device_time_total for e in ka
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    return dict(
        wall_us=wall_us, device_busy_us=busy_us,
        device_idle_share=1.0 - busy_us / wall_us,
        counted_launches=counter() - before,
        kernel_launches=sum(e.count for e in ka if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")),
        host_syncs=sum(e.count for e in ka
                       if e.key == "aten::_local_scalar_dense"),
        htod_copies=sum(e.count for e in ka if "Memcpy HtoD" in e.key),
        top_cpu_us=top_cpu)


def phase_pair_icp():
    """Config 1 at 8k to 256k points: both tiers' registrations/s
    (slope of a K-registration loop), recovery errors, matched fractions,
    the tier icp_auto picks, and launches and syncs a registration."""
    import torch

    from tpu_slam_torch.kernels.icp_terms import (icp_terms_plain,
                                                  icp_terms_raster)
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.registration.icp import AUTO_CROSSOVER, icp_auto
    from tpu_slam_torch.utils.devtime import slope_time

    dev = torch.device("cuda")
    pairs = {label: config1_pair(dev, n_az) for n_az, label in C1_SIZES}
    plain_before = (icp_terms_plain.launches, nearest_neighbors_plain.launches)
    torch.cuda.synchronize()
    icp_terms_raster.launches = 0
    nearest_neighbors.launches = 0
    out, rate = {}, {}
    for label, (src, tgt, xi) in pairs.items():
        at_start = (icp_terms_raster.launches, nearest_neighbors.launches)
        r0, rr = raster_register(src, tgt)
        rb = brute_register(src, tgt)
        torch.cuda.synchronize()
        for tier, reg in (("raster", lambda T, s=src, t=tgt:
                           raster_register(s, t, T)[1]),
                          ("brute", lambda T, s=src, t=tgt:
                           brute_register(s, t, T))):
            dt = slope_time(registration_loop(reg, dev),
                            *C1_SLOPE_K[(tier, label)], device=dev)
            rate[(tier, label)] = 1.0 / dt
        n_valid = int(src.mask.sum())
        prof_r = registration_profile(lambda: raster_register(src, tgt),
                                      lambda: icp_terms_raster.launches)
        prof_b = registration_profile(lambda: brute_register(src, tgt),
                                      lambda: nearest_neighbors.launches)
        iters_r = int(r0.iterations) + int(rr.iterations)
        out[label] = dict(
            points=int(src.capacity), valid_points=n_valid,
            raster_registrations_per_sec=rate[("raster", label)],
            brute_registrations_per_sec=rate[("brute", label)],
            raster_recovery_err_mm=recovery_err_mm(xi, rr.T),
            brute_recovery_err_mm=recovery_err_mm(xi, rb.T),
            raster_iterations=[int(r0.iterations), int(rr.iterations)],
            brute_iterations=int(rb.iterations),
            raster_iters_per_sec=iters_r * rate[("raster", label)],
            brute_iters_per_sec=int(rb.iterations) * rate[("brute", label)],
            raster_matched_fraction=float(rr.matched_fraction),
            brute_matched_fraction=float(rb.matched_fraction),
            # one registration from the identity each (the timed loops
            # start each one from the last result, so take fewer steps)
            raster_profile=prof_r, brute_profile=prof_b,
            # this size's share of the phase's launches
            icp_terms_launches=icp_terms_raster.launches - at_start[0],
            nn_search_launches=nearest_neighbors.launches - at_start[1])

    # the tier icp_auto routes each size to, seen from the kernel counters
    auto = {}
    _, _, fine = config1_params()
    origin = torch.tensor(C1_ORIGIN, device=dev)
    for label, (src, tgt, _) in pairs.items():
        nn0 = nearest_neighbors.launches
        icp_auto(src, tgt, params=fine, origin_world=origin,
                 axis_perm=C1_PERM, **C1_FINE)
        auto[label] = "brute" if nearest_neighbors.launches > nn0 else "raster"
    torch.cuda.synchronize()
    launches = icp_terms_raster.launches
    nn_launches = nearest_neighbors.launches
    faster = [label for _, label in C1_SIZES
              if rate[("raster", label)] > rate[("brute", label)]]
    e8 = out["8k"]
    # bench_icp_pair's keys at 8k and 32k; its iters_per_sec counts the
    # fine call's iterations
    emit("pair_icp", sizes=out, auto_crossover=AUTO_CROSSOVER,
         raster_faster_at=faster,
         registrations_per_sec=e8["raster_registrations_per_sec"],
         iters_per_sec=e8["raster_iterations"][1]
         * e8["raster_registrations_per_sec"],
         recovery_err_mm=e8["raster_recovery_err_mm"],
         brute_registrations_per_sec=e8["brute_registrations_per_sec"],
         brute_recovery_err_mm=e8["brute_recovery_err_mm"],
         raster_32k_registrations_per_sec=out["32k"][
             "raster_registrations_per_sec"],
         brute_32k_registrations_per_sec=out["32k"][
             "brute_registrations_per_sec"],
         auto_tier_8k=auto["8k"], auto_tier_32k=auto["32k"], auto_tiers=auto,
         points=e8["points"], icp_terms_launches=launches,
         nn_search_launches=nn_launches)
    if (icp_terms_plain.launches,
            nearest_neighbors_plain.launches) != plain_before:
        raise AssertionError("config 1 ran a plain kernel version")
    if launches <= 0 or nn_launches <= 0:
        raise AssertionError("config 1 launched no icp_terms or no nn_search "
                             "kernel")
    for label, r in out.items():
        bars = ((C1_RASTER_BAR_MM, C1_BRUTE_BAR_MM) if label == "8k"
                else (C1_LARGE_BAR_MM, C1_LARGE_BAR_MM))
        for tier, bar in zip(("raster", "brute"), bars):
            err = r[f"{tier}_recovery_err_mm"]
            if not err <= bar:
                raise AssertionError(f"config 1 {label} {tier}: recovery "
                                     f"error {err} mm above {bar} mm")
    return launches, nn_launches, pairs


def icp_work(slots, table, T, dims, qt):
    """Bytes the ICP terms pass must move and the float32 operations it
    does on this data. Bytes: every slot's valid flag; the point (12) and
    cell (4) of each kept slot; of each target slot in a touched cell, its
    point and flag (16) when valid, else the flag (4); T and the 30
    outputs. Flops: 18 a kept slot for the transform and ~40 for the 6x6
    expansion, 9 a visited valid target slot (residual, d2, compare)."""
    import torch

    wx, wy, wz = dims
    g = wx * wy * wz
    v = slots.valid
    c = slots.cell.long()
    cx, cy, cz = c // (wy * wz), (c // wz) % wy, c % wz
    tvalid = (table[:, 3] > 0.5).view(g, qt)
    touched, visited = [], 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (v & (nx >= 0) & (nx < wx) & (ny >= 0) & (ny < wy)
                      & (nz >= 0) & (nz < wz))
                nc = torch.clamp((nx * wy + ny) * wz + nz, 0, g - 1)
                touched.append(nc[ok])
                visited += int((ok[:, None] & tvalid[nc]).sum())
    cells = torch.unique(torch.cat(touched))
    n_full = int(tvalid[cells].sum())
    n_slots = int(cells.numel()) * qt
    n = slots.cell.shape[0]
    n_valid = int(v.sum())
    nbytes = (n + n_valid * (12 + 4) + n_full * 16 + (n_slots - n_full) * 4
              + 64 + 30 * 4)
    flops = n_valid * (18 + 40) + visited * 9
    return nbytes, flops, dict(slots=n_valid, touched_cells=int(cells.numel()),
                               touched_valid_target_slots=n_full,
                               visited_pairs=visited)


def icp_blocks(out):
    """(label, tensor) for each part of an ICP terms result held to its own
    scale, as terms_blocks does for NDT."""
    H, b, err, _, wsum = out
    return [("H_tt", H[:3, :3]), ("H_tr", H[:3, 3:]), ("H_rt", H[3:, :3]),
            ("H_rr", H[3:, 3:]), ("b_t", b[:3]), ("b_r", b[3:]),
            ("err", err), ("wsum", wsum)]


def icp_choice_equal(args):
    """Whether the kernel picks the plain version's target for every slot
    (its per-slot choice output against ``icp_match_plain``)."""
    import torch

    from tpu_slam_torch.kernels import icp_terms as I

    slots, table, T, corr, delta, dims, _, qt = args
    choice = torch.empty(slots.cell.shape[0], dtype=torch.int32,
                         device=table.device)
    I.run_kernels(slots, table, T, *I._gate_constants(corr, delta), dims, qt,
                  choice=choice)
    row = I.icp_match_plain(slots, table, T, dims, qt)[3]
    return torch.equal(choice.long(), row)


def check_icp_case(name, args, build=None):
    """icp_terms vs its plain version on one case, and each slot's chosen
    target identical."""
    from tpu_slam_torch.kernels.icp_terms import (KERNEL_NAMES,
                                                  icp_terms_plain,
                                                  icp_terms_raster)

    slots, table, T, _, _, dims, qs, qt = args
    if not icp_choice_equal(args):
        raise AssertionError(f"icp_terms {name}: a slot's chosen target "
                             "differs from the plain version's")
    return dict(check_sums_case(name, icp_terms_raster, icp_terms_plain,
                                args, icp_blocks, 3,
                                icp_work(slots, table, T, dims, qt),
                                KERNEL_NAMES, build=build), dims=list(dims),
                qs=qs, qt=qt, choice_equal=True)


def config1_stage_args(src, tgt, init_T, stage):
    """The terms pass's inputs at the entry of a config-1 raster call:
    the source binned at the call's initial pose, the target table."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster
    from tpu_slam_torch.registration.icp import raster_problem

    _, coarse, fine = config1_params()
    params, geo = (coarse, C1_COARSE) if stage == "coarse" else (fine,
                                                                 C1_FINE)
    origin = torch.tensor(C1_ORIGIN, device=src.points.device)
    prob = raster_problem(src, tgt, init_T, geo["dims"], geo["leaf"], 8,
                          origin, C1_PERM)
    slots, _ = build_terms_raster(prob.source.points, prob.source.mask,
                                  prob.init_T, prob.origin, geo["leaf"],
                                  geo["dims"], 8)
    return (slots, prob.tgt_table, prob.init_T, params.max_corr_dist,
            params.huber_delta, geo["dims"], 8, 8)


def icp_edge_case(device, seed=0, dims=(16, 8, 8), q=4, leaf=0.5):
    """A seeded ICP terms case: random points over the window and 0.3 m
    beyond it, a cell over capacity on both sides, points in the x = 0 and
    x = Wx-1 planes, 30 padding rows, and three tie groups (a source point
    with two equally near targets: across dx, inside one cell's slots,
    across dy against dz) in a cleared region. T is a translation by
    binary fractions, so the ties are exact on the card."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                                  raster_to_slots)

    rng = np.random.default_rng(seed)
    ext = np.asarray(dims, np.float64) * leaf
    t = np.array([0.0625, -0.03125, 0.015625])
    tie_src = np.array([[5.25, 1.25, 1.25], [6.75, 2.75, 2.75],
                        [5.25, 3.25, 1.25]])
    tie_tgt = np.array([[5.75, 1.25, 1.25], [4.75, 1.25, 1.25],
                        [6.75, 2.625, 2.75], [6.875, 2.75, 2.75],
                        [5.25, 3.25, 0.75], [5.25, 2.75, 1.25]])
    tgt = rng.uniform(-0.3, ext + 0.3, (3000, 3))
    tgt[:10] = 0.5 * ext + 0.1                          # over capacity
    tgt[10:40, 0] = rng.uniform(0.0, leaf, 30)          # x = 0 plane
    tgt[40:70, 0] = ext[0] - rng.uniform(0.0, leaf, 30)  # x = Wx-1 plane
    near = np.min(np.linalg.norm(tgt[:, None] - tie_src[None], axis=2),
                  axis=1)
    tgt = np.concatenate([tgt[near > 1.0], tie_tgt]).astype(np.float32)
    # the source: 2,000 of the targets with 5 cm noise (those near the tie
    # groups left out), a crowded cell, the ties, padding; in its own
    # frame, x = T^-1 p
    pick = rng.permutation(len(tgt) - 6)[:2000]
    pick[:60] = np.arange(10, 70)             # the edge-plane points
    src = tgt[pick] + rng.normal(0, 0.05, (2000, 3))
    near = np.min(np.linalg.norm(src[:, None] - tie_src[None], axis=2),
                  axis=1)
    src = np.concatenate([src[near > 1.0], np.full((20, 3), 0.3 * ext + 0.1),
                          tie_src])
    src = np.concatenate([src - t, np.full((30, 3), 1e8)]).astype(np.float32)
    mask = np.ones(len(src), bool)
    mask[-30:] = False
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = t
    g = lambda x, dt=torch.float32: torch.as_tensor(  # noqa: E731
        x, dtype=dt, device=device)
    origin = g(np.zeros(3))
    slots, _ = build_terms_raster(g(src), g(mask, torch.bool), g(T), origin,
                                  leaf, dims, q)
    tslots, _ = build_terms_raster(g(tgt), g(np.ones(len(tgt), bool),
                                             torch.bool),
                                   g(np.eye(4)), origin, leaf, dims, q)
    return (slots, raster_to_slots(tslots, dims, q), g(T), 1.0, 0.3, dims,
            q, q)


def probe_icp_args(pairs):
    """benchmarks/_probe_icp_kernel.py's windows on config 1's 8k pair:
    unpermuted, binned at the identity, scored at a pose 1e-6 m off it.
    Returns [(label, icp_terms args, the source binning)]."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                                  raster_to_slots)

    src, tgt, _ = pairs["8k"]
    dev = src.points.device
    origin = torch.tensor([-8.0, -8.0, -4.0], device=dev)
    eye = torch.eye(4, device=dev)
    T = eye.clone()
    T[0, 3] += 1e-6
    out = []
    for dims, q in (((32, 32, 16), 8), ((16, 32, 16), 8), ((32, 32, 16), 4)):
        tslots, _ = build_terms_raster(tgt.points, tgt.mask, eye, origin, 0.5,
                                       dims, q)

        def build(dims=dims, q=q):
            return build_terms_raster(src.points, src.mask, eye, origin, 0.5,
                                      dims, q)

        out.append((f"probe_{dims[0]}x{dims[1]}x{dims[2]}_q{q}",
                    (build()[0], raster_to_slots(tslots, dims, q), T, 1.5,
                     0.5, dims, q, q), build))
    return out


def phase_icp_kernels(pairs):
    """icp_terms against its plain version on the card: config 1's coarse
    and fine stage inputs at 8k and 32k, _probe_icp_kernel.py's windows
    (with the source binning timed beside the pass), and the edge case;
    then nn_search on the brute tier's first NN pass at 8k, 64k and
    128k."""
    cases = []
    for label in ("8k", "32k"):
        src, tgt, _ = pairs[label]
        r0, _ = raster_register(src, tgt)
        cases.append(check_icp_case(f"c1_{label}_coarse", config1_stage_args(
            src, tgt, None, "coarse")))
        cases.append(check_icp_case(f"c1_{label}_fine", config1_stage_args(
            src, tgt, r0.T, "fine")))
    for label, args, build in probe_icp_args(pairs):
        cases.append(check_icp_case(label, args, build=build))
    dev = pairs["8k"][0].points.device
    cases.append(check_icp_case("edges", icp_edge_case(dev)))
    emit("kernels", kernels=["icp_terms"], cases=cases,
         rtol_of_max=RTOL_OF_MAX,
         check="nmatch exactly equal, each slot's target identical")
    # the brute tier's NN pass at its first iteration, 8k x 8k to 128k
    nn_cases = []
    for label in ("8k", "64k", "128k"):
        src, tgt, _ = pairs[label]
        nn_cases.append(check_nn_case(f"c1_{label}_first_iteration",
                                      src.points, tgt.points, src.mask,
                                      tgt.mask))
    emit("kernels", kernels=["nn_search"], cases=nn_cases,
         check="indices equal, squared distances bit-equal")
    return cases, nn_cases


# ---------------------------------------------------------------------------
# The gather probes (benchmarks/_pallas_gather_probe.py, _gather_probe.py,
# _dyngather_probe.py)
# ---------------------------------------------------------------------------

def gather_work(table, idx, out, per_element=False):
    """Bytes a gather must move: the indices, the distinct table values
    they reach (in-table indices only), the output; each once."""
    import torch

    cols = table.shape[1]
    ok = (idx >= 0) & (idx < table.shape[0])
    if per_element:
        j = torch.arange(cols, device=idx.device).expand_as(idx)
        n_values = int(torch.unique((idx.long() * cols + j)[ok]).numel())
    else:
        n_values = int(torch.unique(idx[ok]).numel()) * cols
    return idx.numel() * 4 + n_values * 4 + out.numel() * 4


def check_gather_case(name, kernel, plain, args, library=None,
                      per_element=False):
    """A gather kernel vs its plain version: bit-equal; times and bound."""
    import torch

    got = kernel(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, ref):
        raise AssertionError(f"{kernel.__name__} {name}: differs from the "
                             f"plain version by "
                             f"{float((got - ref).abs().max())}")
    # the wrapper and the library call are both host-bound at these sizes:
    # time them in turns (wrapper, library, library, wrapper) and average
    turns = [time_ms(lambda: kernel(*args), 100)]
    library_ms = library_us = None
    if library is not None:
        lib = [time_ms(library, 100), time_ms(library, 100)]
        library_ms = sum(lib) / 2
        library_us = device_us_total(library, 20)
    turns.append(time_ms(lambda: kernel(*args), 100))
    ms = sum(turns) / 2
    clocks = clocks_now()
    plain_ms = time_ms(lambda: plain(*args), 5)
    # the profiler can lose a short kernel's events in a whole profile:
    # profile again; a replayed CUDA graph of calls gives a second reading
    for _ in range(3):
        per_kernel, _ = device_time_us(lambda: kernel(*args), 20)
        mine = {k: t for k, t in per_kernel.items()
                if f"{kernel.__name__}_kernel" in k}
        if mine:
            break
    graph_us, _ = graph_time_us(lambda: kernel(*args))
    nbytes = gather_work(args[0], args[1], got, per_element)
    return dict(case=name, kernel=kernel.__name__,
                table=list(args[0].shape), idx=list(args[1].shape),
                table_offset_bytes=args[0].data_ptr() % 16,
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library_device_us=library_us,
                kernel_device_us=sum(mine.values()) or None,
                kernel_names=[k[:72] for k in mine],
                graph_us_per_call=graph_us,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=nbytes, clocks_after_timing=clocks)


def phase_probes():
    """The three probe ports on the card (their main path: every variant
    at the original sizes), then each gather kernel against its plain
    version at the probes' shapes."""
    import torch

    from tpu_slam_torch.benchmarks import (_dyngather_probe, _gather_probe,
                                           _pallas_gather_probe)
    from tpu_slam_torch.kernels import gather as G

    kernels = (G.gather_rows, G.gather_row_sum, G.onehot_gather)
    plains = (G.gather_rows_plain, G.gather_row_sum_plain,
              G.onehot_gather_plain)
    plain_before = [p.launches for p in plains]
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    results = [m.main("cuda") for m in (_pallas_gather_probe, _gather_probe,
                                        _dyngather_probe)]
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    emit("probes", probes=results, launches=launches)
    if [p.launches for p in plains] != plain_before:
        raise AssertionError("the probes ran a plain gather version")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the probes launched no {name} kernel")
    for r in results:
        for variant, v in (r.get("variants") or r["forms"]).items():
            if v.get("correct") is False:
                raise AssertionError(f"probe {r['probe']}: {variant} wrong")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(a):
        return torch.as_tensor(a, device=dev)

    tab4k = t(rng.normal(size=(4096, 16)).astype(np.float32))
    idx32k = t(rng.integers(0, 4096, 32768).astype(np.int32))
    tab32k = t(rng.normal(size=(32768, 16)).astype(np.float32))
    key32k = t(rng.integers(0, 32768, 32768).astype(np.int32))
    tab8k = t(rng.normal(size=(8192, 128)).astype(np.float32))
    lane = t(rng.integers(0, 8192, (8192, 128)).astype(np.int32))
    sub = t(rng.integers(0, 8192, (4096, 128)).astype(np.int32))
    tab2k = t(rng.normal(size=(2048, 128)).astype(np.float32))
    idx256 = t(rng.integers(0, 2048, 256).astype(np.int32))
    big = t(rng.normal(size=4096 * 16 + 1).astype(np.float32))
    tab4k_off = big[1:].view(4096, 16)
    tab7 = t(rng.normal(size=(4096, 7)).astype(np.float32))
    lane7 = t(rng.integers(0, 4096, (32768, 7)).astype(np.int32))
    cases = [
        check_gather_case("row4_take_32k_of_4k", G.gather_rows,
                          G.gather_rows_plain, (tab4k, idx32k),
                          library=lambda: tab4k.index_select(0, idx32k)),
        check_gather_case("row6_per_lane_8k_x128", G.gather_rows,
                          G.gather_rows_plain, (tab8k, lane),
                          library=lambda l=lane.long(): torch.take_along_dim(
                              tab8k, l, 0), per_element=True),
        check_gather_case("row7_sub_4k_of_8k_x128", G.gather_rows,
                          G.gather_rows_plain, (tab8k, sub),
                          library=lambda s=sub.long(): torch.take_along_dim(
                              tab8k, s, 0), per_element=True),
        # no single PyTorch call gathers and sums the rows
        check_gather_case("row5_row_sum_32k_of_32k", G.gather_row_sum,
                          G.gather_row_sum_plain, (tab32k, key32k)),
        # nor gathers and rounds to bfloat16
        check_gather_case("row4_onehot_bf16_32k_of_4k", G.onehot_gather,
                          G.onehot_gather_plain, (tab4k, idx32k, True)),
        check_gather_case("row8_onehot_f32_256_of_2k", G.onehot_gather,
                          G.onehot_gather_plain, (tab2k, idx256),
                          library=lambda: tab2k.index_select(0, idx256)),
        # gather_rows's scalar path: a table 4 bytes off 16-byte alignment
        # (a view into a larger buffer), and an odd width, per row and per
        # element
        check_gather_case("rows_misaligned_32k_of_4k", G.gather_rows,
                          G.gather_rows_plain, (tab4k_off, idx32k),
                          library=lambda: tab4k_off.index_select(0, idx32k)),
        check_gather_case("rows_7_cols_32k_of_4k", G.gather_rows,
                          G.gather_rows_plain, (tab7, idx32k),
                          library=lambda: tab7.index_select(0, idx32k)),
        check_gather_case("per_element_7_cols", G.gather_rows,
                          G.gather_rows_plain, (tab7, lane7),
                          library=lambda l=lane7.long(): torch.take_along_dim(
                              tab7, l, 0), per_element=True),
    ]
    emit("kernels", kernels=[k.__name__ for k in kernels], cases=cases,
         check="bit-equal to the plain version")
    # gather_rows takes its float4 path on the probes' aligned tables and
    # its scalar path on the others (the profiler's kernel names, where it
    # saw the kernel)
    vector_cases = ("row4_take_32k_of_4k", "row6_per_lane_8k_x128",
                    "row7_sub_4k_of_8k_x128")
    for c in cases:
        if c["kernel"] == "gather_rows" and c["kernel_names"]:
            vec = c["case"] in vector_cases
            if not all(("kernel<true," in k) == vec
                       for k in c["kernel_names"]):
                raise AssertionError(f"gather_rows {c['case']}: path "
                                     f"{c['kernel_names']}")
    return launches, cases


def kernel_entry(name, source, replaces, launches, cases, main):
    """One kernel's object of the final JSON line; ``main`` is the case
    whose times stand for the kernel."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main.get("library_ms")}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 2
    import tpu_slam_torch  # noqa: F401  (fails outside a checkout)
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    t_start = time.perf_counter()
    phase_env()
    phase_build()
    t0 = time.perf_counter()
    clouds, gt = city_scans(N_SCANS, "cuda")
    emit("workload", scans=N_SCANS, seconds=time.perf_counter() - t0,
         rays_per_scan=int(clouds[0].capacity),
         mean_valid_rays=float(np.mean([int(c.mask.sum()) for c in clouds])))
    engine = DenseLidarOdometry(config2())
    cases = phase_kernels(engine, clouds, gt)
    launches = phase_slice(engine, clouds, gt)
    phase_profile(engine, clouds, gt)
    phase_determinism(clouds, gt)
    del clouds, engine

    t1 = time.perf_counter()
    c4_clouds, c4_gt = config4_scans("cuda")
    emit("workload", config=4, scans=len(c4_clouds),
         seconds=time.perf_counter() - t1,
         rays_per_scan=int(c4_clouds[0].capacity),
         mean_valid_rays=float(np.mean([int(c.mask.sum())
                                        for c in c4_clouds])))
    run = phase_slam(c4_clouds, c4_gt)
    with tempfile.TemporaryDirectory() as tmpdir:
        phase_slam_resume(run, c4_clouds, tmpdir)
    nn_cases = phase_nn_kernels(run)

    icp_launches, nn_c1_launches, pairs = phase_pair_icp()
    icp_cases, nn_c1_cases = phase_icp_kernels(pairs)
    gather_launches, gather_cases = phase_probes()

    emit("total", seconds=time.perf_counter() - t_start)
    by_case = {c["case"]: c for c in gather_cases}
    src = "tpu_slam_torch/csrc/"
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [
        # ndt_terms: no single PyTorch call computes it
        kernel_entry("ndt_terms", src + "ndt_terms.cu",
                     "tpu_slam/kernels/ndt_terms.py:199", launches, cases,
                     cases[0]),
        # launches on both of its paths: config 4's verification, config
        # 1's brute tier
        kernel_entry("nn_search", src + "nn_search.cu",
                     "tpu_slam/kernels/nn_search.py:57",
                     run["nn_launches"] + nn_c1_launches,
                     nn_cases + nn_c1_cases, nn_cases[0]),
        # icp_terms: no single PyTorch call computes it
        kernel_entry("icp_terms", src + "icp_terms.cu",
                     "tpu_slam/kernels/icp_terms.py:47", icp_launches,
                     icp_cases, icp_cases[1]),
        kernel_entry("gather_rows", src + "gather.cu",
                     "benchmarks/_pallas_gather_probe.py:62 (k_take; and "
                     "k_taa :68, k_adv :75, k_scalar :96); "
                     "benchmarks/_dyngather_probe.py:58 (k_eq), :88 (k_sub)",
                     gather_launches["gather_rows"],
                     [c for c in gather_cases
                      if c["kernel"] == "gather_rows"],
                     by_case["row4_take_32k_of_4k"]),
        kernel_entry("gather_row_sum", src + "gather.cu",
                     "benchmarks/_gather_probe.py:127 (gk)",
                     gather_launches["gather_row_sum"],
                     [by_case["row5_row_sum_32k_of_32k"]],
                     by_case["row5_row_sum_32k_of_32k"]),
        kernel_entry("onehot_gather", src + "gather.cu",
                     "benchmarks/_pallas_gather_probe.py:81 (k_onehot); "
                     "benchmarks/_dyngather_probe.py:106 (k_onehot)",
                     gather_launches["onehot_gather"],
                     [c for c in gather_cases
                      if c["kernel"] == "onehot_gather"],
                     by_case["row8_onehot_f32_256_of_2k"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
