#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: dense odometry (bench config 2)
and full SLAM on the dense engine (bench config 4).

    python3 chip_smoke.py

Phases, each printing one JSON line:

  env          torch / CUDA / nvcc / triton versions and the card
  build        nvcc builds every CUDA source of tpu_slam_torch/csrc, one
               compiler per source, all started together
  kernels      ndt_terms against its plain PyTorch version on the card, at
               the shapes of config 2 (the fine (192, 192, 32) field at
               Q=4, the wide field at Q=8) and on a seeded edge case;
               CUDA-event times and the bound
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
               of the slam run's own keyframes (6 pairs x 4,096 points) and
               a seeded edge case (ties, padding, ragged sizes, one pair);
               indices equal, squared distances bit-equal, times and bound

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
# kernel vs plain: each 3x3 block of H, each half of b, and the cost within
# this fraction of that part's own largest magnitude (float32 sums in
# another order); matched count exactly equal, since both round the
# transform and the gate distance op by op
RTOL_OF_MAX = 1e-4


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


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
    listed again under their own names."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            out[e.key] = e.self_device_time_total / reps
    return out, prof


def check_terms_case(name, args):
    """Kernel vs plain on one case; returns the case's numbers."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    slots, rows16, T, gamma, max_corr, dims = args
    got = ndt_terms(*args)
    ref = ndt_terms_plain(*args)
    torch.cuda.synchronize()
    errs, rel = [], {}
    for (label, a), (_, b) in zip(terms_blocks(got), terms_blocks(ref)):
        err = float((a - b).abs().max())
        scale = float(b.abs().max())
        if not err <= RTOL_OF_MAX * max(scale, 1e-30):
            raise AssertionError(f"ndt_terms {name}: {label} off by {err} "
                                 f"(scale {scale})")
        errs.append(err)
        rel[label] = err / max(scale, 1e-30)
    if float(got[3]) != float(ref[3]):
        raise AssertionError(f"ndt_terms {name}: matched {float(got[3])} "
                             f"!= plain {float(ref[3])}")
    if not float(ref[3]) > 0:
        raise AssertionError(f"ndt_terms {name}: nothing matched")
    ms = time_ms(lambda: ndt_terms(*args), 50)
    plain_ms = time_ms(lambda: ndt_terms_plain(*args), 5)
    # the event time above includes the wrapper's host work when that is
    # longer than the device work; the profiler splits out the kernel
    per_kernel, _ = device_time_us(lambda: ndt_terms(*args), 20)
    kernel_us = sum(t for k, t in per_kernel.items()
                    if "ndt_terms_kernel" in k)
    nbytes, flops, counts = terms_work(slots, rows16, T, max_corr, dims)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(case=name, dims=list(dims), n_slots=slots.cell.shape[0],
                matched=float(got[3]), max_abs_err=max(errs),
                rel_err_of_block_max=rel, ms=ms, plain_ms=plain_ms,
                kernel_device_us=kernel_us or None,
                wrapper_device_us=sum(per_kernel.values()) or None,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, **counts)


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


def phase_kernels(engine, clouds, gt):
    """Warm the engine on the first scans, then hold the kernel against its
    plain version on the main path's own inputs."""
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
    cases = [check_terms_case("fine_q4", (slots, fine.rows, T,
                                          cfg.ndt.score_temperature,
                                          cfg.ndt.max_corr_dist,
                                          engine.dims))]

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
    cases.append(check_terms_case(
        "wide_q8", (cslots, wide.rows, T,
                    cp.score_temperature * cp.coarse_temperature_scale,
                    cp.max_corr_dist, engine.dims)))
    cases.append(check_terms_case("edges", random_terms_case(dev)))
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
                   if "ndt_terms_kernel" in k)
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


def check_nn_case(name, q, t, q_mask, t_mask):
    """Kernel vs plain on one case: indices equal and squared distances
    bit-equal on every query (padding queries included); times and bound."""
    import torch

    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)

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
    plain_ms = time_ms(lambda: nearest_neighbors_plain(q, t), 3)
    library_ms = time_ms(lambda: torch.cdist(
        q, t, compute_mode="donot_use_mm_for_euclid_dist").min(-1), 5)
    per_kernel, _ = device_time_us(lambda: nearest_neighbors(q, t), 10)
    kernel_us = sum(v for k, v in per_kernel.items()
                    if "nn_search_kernel" in k)
    if not kernel_us:
        # a profiled cycle has come back without device events on the
        # card; profile once more
        per_kernel, _ = device_time_us(lambda: nearest_neighbors(q, t), 10)
        kernel_us = sum(v for k, v in per_kernel.items()
                        if "nn_search_kernel" in k)
    nbytes, flops = nn_work(q, t, q_mask, t_mask)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return dict(case=name, shape=[list(q.shape), list(t.shape)],
                valid_queries=int(q_mask.sum()),
                valid_targets=int(t_mask.sum()), max_abs_err=err,
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                kernel_device_us=kernel_us or None,
                device_us_by_kernel=sorted(
                    ((k[:60], v) for k, v in per_kernel.items()),
                    key=lambda kv: -kv[1])[:4],
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops)


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
             check_nn_case("edges", *nn_edge_case(dev))]
    emit("kernels", kernels=["nn_search"], cases=cases,
         check="indices equal, squared distances bit-equal")
    return cases


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

    emit("total", seconds=time.perf_counter() - t_start)
    main_case, nn_main = cases[0], nn_cases[0]
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [{
        "name": "ndt_terms", "route": "cuda",
        "source": "tpu_slam_torch/csrc/ndt_terms.cu",
        "replaces": "tpu_slam/kernels/ndt_terms.py:199",
        "launches": launches,
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"], "library_ms": None}, {
        "name": "nn_search", "route": "cuda",
        "source": "tpu_slam_torch/csrc/nn_search.cu",
        "replaces": "tpu_slam/kernels/nn_search.py:57",
        "launches": run["nn_launches"],
        "max_abs_err": max(c["max_abs_err"] for c in nn_cases),
        "ms": nn_main["ms"], "plain_ms": nn_main["plain_ms"],
        "bound_ms": nn_main["bound_ms"], "bound_by": nn_main["bound_by"],
        "library_ms": nn_main["library_ms"]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
