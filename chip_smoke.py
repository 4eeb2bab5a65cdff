#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU: dense odometry (bench config 2),
full SLAM on the dense engine (bench config 4), pair ICP on both tiers
(bench config 1), the gather probes, the dense engine's options, the host
engine on the sparse voxel map (LidarOdometry, JitLidarOdometry and
SLAMSystem on it), scan-to-map NDT on the sparse voxel map (bench config
3), the registration layer's compiled programs against their eager forms,
bag replay through the CLI (bench config 6), the distributed layer
(bench config 5: the sharded map and NDT; the sharded dense step, ICP
batch and pose-graph solvers; the heartbeat), the rotating unit's live
chain (CoLa-A stream -> native poller -> aggregator -> SLAM, and run_live)
with the live SLAM path's compiled programs, the default SLAM's loop
sweep and the host engine's options against their eager forms, and the
extrinsic calibration.

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
               24-scan city route (65,536 rays a scan), on its captured
               step (the default; every later phase runs the captured step
               and the captured graph solves too): scans/s synced and
               unsynced, ATE, matched fraction, iterations, kernel launches
               per scan (a wrapper's eager calls plus the calls its graphs'
               replays made), peak memory
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
  compiled     the reference's compiled programs against their eager
               forms (compiled=False): config 2's 24 scans on the captured
               step and on the host-exit step from fresh engines (poses,
               iterations and matched fractions bit-equal; scans/s synced
               and with sync_every=0, p50/p95, the capture's seconds and
               memory; 6 captured steps profiled: kernel and graph
               launches, the device's kernels, host reads and
               synchronisations (none), idle share), config 4 eager
               through its first accepting sweep against the slam run
               there (poses and state bit-equal, stage seconds), and the
               sweep's and the final refinement's graph solves on the
               run's final graph (seconds, bit-equal, the captured form's
               launches a GN iteration; the refinement's first 4 of its
               40 GN iterations); the dense solver's one graph on that
               graph and on it padded to 512 nodes, float32 and float64
               (seconds of both forms and of the capture, bit-equal, a
               replay under sync-debug "error", launches a GN iteration
               on both forms, capture seconds and pool bytes)
  kernels      pcg_chunk against the plain CG iterations (one chunk of
               16 from the CG start) on the slam run's final graph at
               1e-8 and with a tolerance that stops it early, and on that
               graph padded to SLAMConfig()'s 512 and 2,048 slots: x, r, p
               within PCG_RTOL_OF_MAX, iterations equal, two launches
               bit-equal, times, bound; config 4's sweep solve of both
               graphs, captured, with the kernel and the plain iterations
  kernels      nn_search against its plain version: a verification batch
               of the slam run's own keyframes (6 pairs x 4,096 points), a
               seeded edge case (ties, padding, ragged sizes, one pair) and
               a case that the kernel splits across blocks (300 queries,
               200,000 targets, ties on split boundaries); indices equal,
               squared distances bit-equal, times, the split plan, bound
               and 8-instruction floor
  pair_icp     config 1 at 8k, 16k, 32k, 64k, 128k and 256k points: the
               raster tier (icp_raster, coarse then fine call, each the
               captured program) and the brute tier (icp, the captured
               program) timed as registrations/s by slope_time (the brute
               tier's loops cut to 1 + 4 registrations at 128k and 256k,
               where each takes 0.2-0.7 s), recovery errors,
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
               versions at the probes' shapes, each on a misaligned table
               view (the scalar path), gather_rows on a 7-column table,
               the row sum and the one-hot at 200 columns: bit-equal, the
               float4 or scalar path by the profiler's kernel names,
               times, bound and the one PyTorch call that computes the
               same function (its ms and device us)
  options      the dense engine with each option on: the dynamic-object
               room with occupancy eviction (box cells before and after,
               all cells), a moving 65,536-ray capture deskewed (median
               distance to the surfaces, deskewed and raw), config 2 with
               use_occupancy twice from fresh engines (ATE, matched
               fraction, evictions, terms launches a step, bit-identical),
               then its 6-scan profile (profile_occupancy)
  host_odometry  LidarOdometry, the sparse voxel-map engine, on config 2's
               route at full width on the kernel path (terms_impl
               "auto"; its registrations the captured programs, as in
               every later phase of the host engine and the live chain): ATE and matched fraction against the reference's
               own run on a CPU (HOST_REF), mean iterations, scans/s
               synced, field builds, incremental inserts and fallbacks,
               voxels at the end, ndt_terms launches a scan, a rerun from a
               fresh engine (bit-identical), then six steps replayed on the
               host clock and under the profiler (launches, device-to-host
               reads, idle share)
  host_engine_cases  the reference's own tests of the host engine at
               their sizes and bars: the outdoor ring and the pyramid's
               capture range on both terms paths (the sparse path to the
               tests' bars, the kernel path's 64^3 cube window to the
               reference's own numbers on that path, REF_KERNEL_PATH), the
               scrolling window against a world-fixed grid, icp_plane and
               icp_point at OdometryConfig()'s capacities, occupancy
               eviction of a moving box, and JitLidarOdometry on the office
               arc and on config 2's route
  slam_host    SLAMSystem on the host engine over the office circle (40
               scans): keyframes, loops, ATE, stage times, launches; a
               checkpoint after scan 20 resumed in a fresh system
               (bit-identical)
  kernels      ndt_terms at host_odometry's (192, 192, 32) window and the
               outdoor ring's 64^3 cube, nn_search at icp_plane's 32,768 x
               131,072 first iteration
  host_phases_total  the seconds of the four host-engine phases
  config3      bench_ndt_register at its size: a 0.5 m map of the grid city
               (453,009 voxels), one VLP-16 street scan; the coarse stage on
               the coarsened map's (64, 64, 16) field, the fine (160, 160,
               32) window with the far tier, from the bench's perturbation:
               error, matched fraction, coverages, the raster's dropped
               points, registrations/s, the stage times (the field from the
               voxel map, grid_ndt_field at the same dims, the raster, the
               terms pass, the dense insert); also written to
               chiprun_out/config3.json
  kernels      ndt_terms against its plain version on config 3's coarse,
               fine and far rasters
  compiled_registration  the registration layer's compiled programs
               against their eager forms (compiled=False) in this call:
               config 3's coarse-then-fine registration, LidarOdometry on
               config 2's route, JitLidarOdometry's jit_arc and
               jit_config2, config 1's raster tier at 8k-256k; all
               bit-equal, every captured call run under sync-debug "error"
               (0 reads or syncs); p50 ms, scans/s and registrations/s,
               terms calls, launches, reads, H2D copies and idle share on
               both forms (the host odometry's profile captured only);
               the input copies' us, the captures' seconds and memory;
               the crossover of pair_icp's rates (the raster tier
               captured against the brute tier)
  config6      bench_bag_replay: VLP-16 packets along config 2's route ->
               pcap -> revolutions -> rosbag with TF ground truth -> the
               port's run_odometry CLI (--engine dense, the bench's --set
               list): scans, ATE, RPE, wall time, scans/s and the share of
               the host conversions
  distributed  tpu_slam_torch.distributed on 4 gloo ranks sharing this
               card (spawned once through distributed.mesh.run_ranks; every
               collective staged through host memory, counted), each case
               against the single device on the same inputs:
               dist_map (config 5 at config 3's scale: the 453,009-voxel
               map split by slab_owner, the street scan through
               insert_cloud_sharded, each rank's keys and counts the single
               map's rows of its slab; ndt_register_sharded on the kernel
               tier over the (160, 160, 32) window from the bench's
               perturbation: pose within 1e-4, score within 1e-3, matched
               equal; registrations/s, collectives and staged bytes a
               registration, rank 0's profile), dist_dense
               (dense_step_sharded, config 2 at pyramid_factor 1 without
               scroll, its 6 scans of 65,536 rays through the turn, the
               first motion seeded: pose within 1e-4 of
               DenseLidarOdometry at every step), dist_icp
               (sharded_pairwise_icp on the slam run's verification batch,
               6 pairs x 4,096 padded to 8: T within 1e-5 of the batched
               icp), dist_graph (optimize_pose_graph_sharded and
               optimize_pose_graph_schur on the slam run's graph against
               optimize_pose_graph's PCG and dense solves: 2e-3 / 1e-2;
               Schur 1e-4 / 1e-4, in float64 against the float64 dense
               solve and in float32 against both the float32 and the
               float64 dense solve, each dense solve captured and
               bit-equal to compiled=False; ms and kernel launches a
               solve),
               dist_health
               (the heartbeat, healthy and with a hung probe); every rank
               bit-identical; then dist_map, dist_icp and dist_graph at
               world size 1 on NCCL (bit-equality to the single device
               recorded; its Schur solves captured, the default there);
               the compiled programs (case "compiled"): compiled=True
               refused on the gloo ranks, the sharded dense step and the
               float32 Schur solve on the NCCL rank on both forms
               (compiled=False and the captured default, its collectives
               in the graph) and the single-process Schur solve on both
               forms in this process: bit-equal, every replay under
               sync-debug "error", one graph a signature, step and solve
               seconds, launches, graph launches and reads of a step and
               of a GN iteration; and what NCCL says to two ranks on one
               card
  kernels      ndt_terms on rank 0's share of dist_map's terms pass and
               nn_search on rank 0's verification shard
  live         the rotating unit's live chain: an LMS100 (541 beams, 270
               degrees) on loopback TCP at 50 Hz, CoLa-A telegrams with the
               mm quantization, the unit turning without a break while the
               base stops at 32 poses of a 2.5 m circle in the office (150
               lines a 3D scan, 4,800 lines) -> NativeLms -> NativeFeeder ->
               FrameChain -> ScanAggregator -> SLAMSystem on the host engine:
               points a scan, feeder drops (must be 0), lines/s, SLAM step
               p50/p95, keyframes, loops, ATE against the route held within
               0.02 m of the reference's CPU run (LIVE_REF); the first 4
               captures again unpaced (bit-identical; lines/s); launches,
               H2D copies and device-to-host reads a line and a scan; the
               device's idle share over a scan
  compiled_slam the live SLAM path's compiled programs (the scan line, the
               map insert, the keyframe store, the batched ICP) against
               compiled=False, every captured call under sync-debug
               "error": the survey's first capture's lines (the cloud bit
               for bit; launches, graph launches, H2D copies, reads and
               host ms a line, the line's own work alone, unpaced
               lines/s), its first 2 captures through SLAMSystem() (clouds
               and poses bit for bit against the paced run), slam_host's
               office circle (poses and final state
               bit for bit; a step's costs over a loop sweep), config 4's
               verification batch (6 pairs x 4,096, also with the NN's
               plain version in place of the kernel; ms, NN calls and its
               us a call inside the graph), config 1's brute tier at
               8k-256k (registrations/s, recovery errors, syncs); and where
               the captured raster tier leads the brute tier
  compiled_host the default SLAM's loop sweep and the host engine's
               options against compiled=False, every captured call under
               sync-debug "error": the survey's 32 clouds through
               SLAMSystem() at SLAMConfig()'s capacities (poses and final
               state bit for bit, and against the live run; each accepted
               sweep's step by stage: candidates, verify, graph,
               re-anchor; the map rebuild's and sc_distance's graphs
               captured once, by the warm-up, and replayed every sweep;
               on the state after each sweep, the rebuild and sc_distance
               alone: ms, launches, graph launches, reads), the dense
               SLAM's default re-anchor (the windows' rebuild, one graph a
               window, one captured step), and config 2's first 8 scans
               on the host engine with the pyramid (factor 2), occupancy
               (64 steps, 65,536 voxels) and deskew on (poses, metrics,
               map and grid bit for bit; step p50, launches, graph
               launches, reads and idle share a step; coarsen_map,
               occupancy_maintain and deskew_cloud alone, both forms)
  live_cli     run_live.main against the fake LMS100 and a fake motor
               controller for 2 scans: its JSON lines; the speed commanded,
               then the unit stopped
  kernels      ndt_terms on the survey's fine field, nn_search on its
               verification batch
  calibration  720 segments x 541 beams (389,520 raw points) in the
               reference test's room with its TRUE_PARAMS, CalibConfig(),
               every program on both forms (compiled=False and the
               captured default, every replay under sync-debug "error",
               one graph a signature): overlap_cost at 6 vectors and alone
               (ms, launches, graph launches, H2D copies and reads a call
               and a twiddle evaluation), a gradient step alone and a
               10-step solve profiled (reads a solve), two eager solves
               bit-equal; twiddle (2,000 evaluations at most), annealing
               (seed 0) and the gradient solver (200 Adam steps) on both
               forms (the same path bit for bit), each one's gauge error
               against the truth (bars 0.04 and 0.025, annealing's cost no
               higher than its start), seconds and evaluations/s, the
               verification's matched fraction; the synthetic ray caster
               on a city scan (65,536 rays x 321 patches) on both forms

then the script's total seconds, the card's name and power limit
(nvidia-smi), one JSON line with every kernel's numbers, and as the last
line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check raises, so the script exits non-zero before the last line.
It needs one CUDA device and nvcc; it imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

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
              ("raster", "128k"): (3, 23), ("brute", "128k"): (1, 4),
              ("raster", "256k"): (3, 23), ("brute", "256k"): (1, 4)}
# kernel vs plain: each 3x3 block of H, each half of b, and the cost within
# this fraction of that part's own largest magnitude (float32 sums in
# another order); matched count exactly equal, since both round the
# transform and the gate distance op by op
RTOL_OF_MAX = 1e-4
# the PCG's chunk kernel vs the plain masked iterations: x, r, p after a
# chunk within this fraction of each one's largest magnitude (float32 sums
# in another order, 16 iterations on an ill-conditioned H; the H100 read
# at most 1.5e-4 on the card tests' graphs)
PCG_RTOL_OF_MAX = 5e-4
PCG_CHUNK = 16                 # the CG iterations a chunk runs
# Config 3 of bench.py (bench_ndt_register) and its reference results
# (BENCH_r05.json); the map is numpy from a seeded sample, so its voxel
# count is exact
C3_MAP_VOXELS = 453_009
C3_SCAN_FLOOR = 16_384
C3_REF = dict(scan_points=18_606, err_mm=1.1, matched=0.823,
              fine_window_coverage=0.837, objective_coverage=0.994,
              raster_dropped=3_464)
C3_ERR_BAR_MM = 3.0
C3_MATCHED_BAR = 0.80
C3_OBJECTIVE_BAR = 0.99
C3_XI = [0.2, -0.15, 0.08, 0.025, -0.015, 0.04]
C3_FINE = (160, 160, 32)
C3_COARSE = (64, 64, 16)
C3_REGISTRATIONS = 20
# Config 6 of bench.py (bench_bag_replay): 25 route poses, of which the
# packet stream yields 24 scans; the bars are config 2's on the same route
# and engine (the reference: ATE 0.0706 m, RPE 0.0038 m)
C6_POSES = 25
C6_SCANS = 24
C6_ATE_BAR_M = 0.10
C6_RPE_BAR_M = 0.005
C6_SETS = ["scan_capacity=32768", "downsample_leaf=0.3", "map_leaf=0.5",
           "map_half_extent=128.0", "map_capacity=262144",
           "scan_max_range=45.0", "insert_downsampled=true",
           "ndt.max_iterations=10", "ndt.coarse_iterations=2",
           "ndt.tolerance=3e-4", "ndt.min_voxel_count=3.0",
           "ndt.window_dims=192,192,32", "pyramid_factor=4",
           "max_pred_translation=2.0"]


_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line: the phase, its fields and the script's seconds so
    far (``at_s``)."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": time.perf_counter() - _T0}), flush=True)


def reset_launches(*wrappers) -> None:
    """Set the launch counts of kernel wrappers to 0, with the CUDA graphs'
    tallies of them (utils.capture)."""
    from tpu_slam_torch.utils.capture import reset_kernel_launches
    reset_kernel_launches(*wrappers)


def launches_of(wrapper) -> int:
    """A kernel wrapper's launches since its reset: its eager calls plus
    the calls its captured graphs' replays made (a captured path calls the
    wrapper once, at the capture; a replay launches the recorded kernel
    without calling it)."""
    from tpu_slam_torch.utils.capture import kernel_launches
    return kernel_launches(wrapper)


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


def terms_abs_scales(args):
    """ndt_terms's H, b and cost with every term taken by its absolute
    value (a gated neighbour's s J^T Lambda J, s J^T Lambda r and s): where
    terms of both signs cancel, float32 sums in two orders differ by a few
    ulps of this scale, not of the total's."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import (_gate_constants,
                                                  _neighbours, _transform)

    slots, rows16, T, gamma, max_corr, dims = args
    inv_2g, maxd2 = _gate_constants(gamma, max_corr)
    px, py, pz = _transform(slots, T)
    zero = torch.zeros_like(px)
    phat = torch.stack([torch.stack([zero, -pz, py], -1),
                        torch.stack([pz, zero, -px], -1),
                        torch.stack([-py, px, zero], -1)], -2)
    J = torch.cat([torch.eye(3, device=px.device).expand_as(phat), -phat],
                  dim=2)                                        # (N, 3, 6)
    H = torch.zeros(6, 6, device=px.device)
    b = torch.zeros(6, device=px.device)
    cost = torch.zeros((), device=px.device)
    for _, s, q, lam in _neighbours(slots, rows16, T, inv_2g, maxd2, dims):
        l00, l01, l02, l11, l12, l22 = lam
        L = torch.stack([torch.stack([l00, l01, l02], -1),
                         torch.stack([l01, l11, l12], -1),
                         torch.stack([l02, l12, l22], -1)], -2)
        H += torch.einsum("nia,nij,njb->nab", J, L * s[:, None, None],
                          J).abs().sum(0)
        b += torch.einsum("nia,ni->na", J,
                          torch.stack(q, -1) * s[:, None]).abs().sum(0)
        cost += s.sum()
    return H, b, cost


def check_terms_case(name, args):
    """ndt_terms vs its plain version on one case; the error is also given
    against the block's sum of absolute terms (terms_abs_scales)."""
    from tpu_slam_torch.kernels.ndt_terms import (KERNEL_NAMES, ndt_terms,
                                                  ndt_terms_plain)

    slots, rows16, T, _, max_corr, dims = args
    out = check_sums_case(name, ndt_terms, ndt_terms_plain, args,
                          terms_blocks, 3,
                          terms_work(slots, rows16, T, max_corr, dims),
                          KERNEL_NAMES)
    got, ref = ndt_terms(*args), ndt_terms_plain(*args)
    out["rel_err_of_abs_terms"] = {
        label: float((a - b).abs().max()) / max(float(s.max()), 1e-30)
        for (label, a), (_, b), (_, s) in zip(
            terms_blocks(got), terms_blocks(ref),
            terms_blocks(terms_abs_scales(args)))}
    return dict(out, dims=list(dims))


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
    reset_launches(ndt_terms)
    t0 = time.perf_counter()
    poses, log = engine.run(clouds, init_pose=gt[0])
    dt = time.perf_counter() - t0
    launches = launches_of(ndt_terms)
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


KERNEL_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                   "cudaLaunchKernelExC")
GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


def device_kernel_count(ka) -> int:
    """Kernels the device ran in a profile (a captured graph's included:
    the profiler sees each kernel of a replay, not its launch), without
    the copies and fills."""
    from torch.autograd import DeviceType

    return sum(e.count for e in ka
               if e.device_type == DeviceType.CUDA
               and not e.is_user_annotation
               and not e.key.startswith(("Memcpy", "Memset")))


def phase_profile(engine, clouds, gt, n=6, label="profile"):
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
    graph_launches = sum(e.count for e in ka if e.key in GRAPH_LAUNCHES)
    emit(label, scans=n, steps=steps,
         wall_ms_per_step=wall_us / 1e3 / steps,
         device_busy_ms_per_step=busy_us / 1e3 / steps,
         ndt_terms_kernel_ms_per_step=terms_us / 1e3 / steps,
         device_idle_share=1.0 - busy_us / wall_us,
         host_syncs_per_step=syncs / steps,
         kernel_launches_per_step=launches / steps,
         graph_launches_per_step=graph_launches / steps,
         device_kernels_per_step=device_kernel_count(ka) / steps,
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
FINAL_REFINE = dict(gn_iterations=40, cg_iterations=800, robust_delta=0.15,
                    robust_kernel="cauchy", trust_loops=True)


def final_refine(graph, compiled=True):
    from tpu_slam_torch.graph.pose_graph import (GraphSolveParams,
                                                 optimize_pose_graph)

    return optimize_pose_graph(graph, GraphSolveParams(**FINAL_REFINE),
                               compiled=compiled)[0]


def is_sweep(cfg, state, m) -> bool:
    """Whether the step that produced (state, m) ran a loop sweep."""
    n = state.n_keyframes
    return bool(m.is_keyframe and n % cfg.loop_every == 0
                and n > cfg.loop.min_index_gap)


def phase_slam(clouds, gt):
    """Config 4 end to end, as bench_full_slam measures it; keeps a host
    snapshot of the state after the first sweep that accepts a loop."""
    import torch

    from tpu_slam_torch.graph import pose_graph as pg
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.kernels.pcg import pcg_chunk
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    cfg = config4()
    slam = SLAMSystem(cfg)
    plain_before = (nearest_neighbors_plain.launches,
                    ndt_terms_plain.launches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(nearest_neighbors, ndt_terms, pcg_chunk)
    t0 = time.perf_counter()
    state = slam.init_state(gt[0])
    poses, kf_scan, snap, sweeps, snap_s = [], [], None, 0, 0.0
    snap_at = None
    for k, c in enumerate(clouds):
        loops_before = state.n_loop_closures
        state, m = slam.step(state, c)
        poses.append(state.odom.pose.cpu().numpy())
        if len(kf_scan) < state.n_keyframes:
            kf_scan.append(k)
        sweeps += is_sweep(cfg, state, m)
        if snap is None and state.n_loop_closures > loops_before:
            ts = time.perf_counter()
            snap_at = dict(seconds=ts - t0,
                           stage_seconds=dict(slam.stage_seconds))
            snap = (k + 1, slam_state_to_numpy(state))
            snap_s = time.perf_counter() - ts
    torch.cuda.synchronize()
    t_refine = time.perf_counter()
    graph = final_refine(state.graph)
    torch.cuda.synchronize()
    refine_s = time.perf_counter() - t_refine
    # the snapshot for slam_resume is not part of the workload
    dt = time.perf_counter() - t0 - snap_s
    nn_launches = launches_of(nearest_neighbors)
    terms_launches = launches_of(ndt_terms)
    pcg_launches = launches_of(pcg_chunk)
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
        pcg_chunk_launches=pcg_launches, stage_seconds=stages, final_refine_seconds=refine_s,
        other_seconds=dt - sum(stages.values()) - refine_s,
        first_accepting_sweep_after_scan=None if snap is None else snap[0],
        peak_memory_bytes=peak)
    emit("slam", **fields)
    if plain_after != plain_before:
        raise AssertionError("the SLAM path ran a plain kernel version")
    if nn_launches <= 0 or terms_launches <= 0:
        raise AssertionError("the SLAM path launched no nn_search or no "
                             "ndt_terms kernel")
    # (a comparison may swap the PCG's chunk kernel for the plain
    # iterations; pg._chunk_kernel then says so)
    if pg._chunk_kernel(state.graph) and pcg_launches <= 0:
        raise AssertionError("the SLAM path's graph solves launched no "
                             "pcg_chunk kernel")
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
                snap_at=snap_at, nn_launches=nn_launches,
                pcg_launches=pcg_launches, fields=fields)


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
        kernel_launches=count(lambda k: k in KERNEL_LAUNCHES),
        graph_launches=count(lambda k: k in GRAPH_LAUNCHES),
        device_kernels=device_kernel_count(ka),
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


# ---------------------------------------------------------------------------
# The compiled programs: the captured step and solve against the eager ones
# ---------------------------------------------------------------------------

COMPILED_WARM = 3              # steps before the profiled ones
COMPILED_REFINE_GN = 4         # the refinement's GN iterations compared
COMPILED_PROFILED = 6          # steps profiled, and timed unprofiled


def steps_profile(engine, state, clouds):
    """``engine.step`` over ``clouds`` from ``state`` (left intact), first
    timed on the host clock, then again under torch.profiler: per step the
    runtime's kernel and graph launches, the kernels the device ran,
    ``ndt_terms`` kernels among them, host syncs (``item`` reads, as the
    ``profile`` phase counts them), copies to the host, explicit
    synchronisations, device busy ms and the idle share (1 - busy / the
    unprofiled wall)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        s = state
        for c in clouds:
            s = engine.step(s, c)
        return s

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    syncs = ("cudaStreamSynchronize", "cudaEventSynchronize",
             "cudaDeviceSynchronize")

    def profiled(fn):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        return prof.key_averages()

    # the synchronisations of a profile of nothing are the profiler's own
    base = sum(e.count for e in profiled(lambda: None) if e.key in syncs)
    ka = profiled(run)
    n = len(clouds)

    def count(keys):
        return sum(e.count for e in ka if e.key in keys)

    dev = [e for e in ka if e.device_type == DeviceType.CUDA
           and not e.is_user_annotation]
    busy_us = sum(e.self_device_time_total for e in dev)
    sync_calls = count(syncs) - base
    return dict(
        wall_ms_per_step=wall * 1e3 / n,
        kernel_launches_per_step=count(KERNEL_LAUNCHES) / n,
        graph_launches_per_step=count(GRAPH_LAUNCHES) / n,
        device_kernels_per_step=device_kernel_count(ka) / n,
        ndt_terms_kernels_per_step=sum(
            e.count for e in dev if "ndt_terms_kernel" in e.key) / n,
        host_syncs_per_step=count(("aten::_local_scalar_dense",)) / n,
        dtoh_copies_per_step=sum(e.count for e in dev
                                 if "Memcpy DtoH" in e.key) / n,
        synchronize_calls_per_step=sync_calls / n,
        device_busy_ms_per_step=busy_us / 1e3 / n,
        device_idle_share=1.0 - busy_us / 1e6 / wall)


def compiled_config2(clouds, gt):
    """Config 2 on the eager host-exit step and on the captured step, fresh
    engines: poses, iterations and matched fractions bit-equal, rates
    synced and with sync_every=0, p50/p95, the one-off capture and the
    memory; the captured step's profile of a few steps (the eager step's
    is in PERF.md and not repeated; its first run is its timed one: it
    captures nothing)."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.pipeline.metrics import MetricsLog, ate_rmse
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    out, keep = {}, {}
    for label, compiled in (("eager", False), ("captured", True)):
        engine = DenseLidarOdometry(config2(), compiled=compiled)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches(ndt_terms)
        t0 = time.perf_counter()
        poses, log = engine.run(clouds, init_pose=gt[0])
        first_s = time.perf_counter() - t0
        first_launches = launches_of(ndt_terms)
        dt = first_s
        if compiled:
            engine.metrics = MetricsLog()
            t0 = time.perf_counter()
            poses, log = engine.run(clouds, init_pose=gt[0])
            dt = time.perf_counter() - t0
        t0 = time.perf_counter()
        poses0, _ = engine.run(clouds, init_pose=gt[0], sync_every=0)
        dt0 = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        prof = None
        if compiled:
            state = engine.init_state(clouds[0], gt[0])
            for c in clouds[1:COMPILED_WARM]:
                state = engine.step(state, c)
            prof = steps_profile(
                engine, state,
                clouds[COMPILED_WARM:COMPILED_WARM + COMPILED_PROFILED])
        summary = log.summary()
        graphs = [g.graph for g in engine.graphs.values()]
        keep[label] = dict(
            poses=poses, poses0=poses0,
            iterations=[m.iterations for m in log.records],
            matched=[m.matched_fraction for m in log.records])
        out[label] = dict(
            first_run_s=first_s, scans_per_s=len(clouds) / dt,
            scans_per_s_sync_every_0=len(clouds) / dt0,
            p50_step_ms=summary["p50_wall_time_s"] * 1e3,
            p95_step_ms=summary["p95_wall_time_s"] * 1e3,
            ate_m=ate_rmse(poses, gt, align=False),
            mean_iterations=summary["mean_iterations"],
            ndt_terms_launches_first_run=first_launches,
            peak_memory_bytes=peak, profile=prof,
            graphs=len(graphs),
            capture_s=[g.capture_s for g in graphs],
            graph_held_bytes=[g.held_bytes for g in graphs],
            graph_pool_bytes=[g.pool_bytes for g in graphs],
            calls_per_replay=[g.calls for g in graphs])
        del engine
    e, c = keep["eager"], keep["captured"]
    same = dict(poses=bool(np.array_equal(e["poses"], c["poses"])),
                poses_sync_every_0=bool(np.array_equal(e["poses0"],
                                                       c["poses0"])),
                iterations=e["iterations"] == c["iterations"],
                matched_fractions=e["matched"] == c["matched"])
    return out, same


def compiled_config4(run, clouds, gt):
    """Config 4 on the eager paths (compiled=False: the host-exit step and
    the eager graph solves) up to and including the first sweep that
    accepts a loop, against the captured run's poses and state there."""
    import torch

    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    k0, snap = run["snap"]
    slam = SLAMSystem(config4(), compiled=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = slam.init_state(gt[0])
    poses = []
    for k in range(k0):
        state, _ = slam.step(state, clouds[k])
        poses.append(state.odom.pose.cpu().numpy())
    seconds = time.perf_counter() - t0
    got = slam_state_to_numpy(state)
    differ = sorted(k for k in snap
                    if not np.array_equal(np.asarray(snap[k]),
                                          np.asarray(got.get(k))))
    return dict(
        scans=k0, loops=state.n_loop_closures,
        keyframes=state.n_keyframes,
        poses_bit_equal=bool(np.array_equal(np.stack(poses),
                                            run["poses"][:k0])),
        state_keys_differing=differ,
        eager=dict(seconds=seconds, stage_seconds=dict(slam.stage_seconds)),
        captured=run["snap_at"])


def gn_iteration_profile(graph, params, compiled):
    """One GN iteration of ``params``' solve of ``graph`` (after a warm
    call, which captures it) under the profiler: the runtime's kernel and
    graph launches, the device's kernels."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_slam_torch.graph.pose_graph import optimize_pose_graph

    one = dataclasses.replace(params, gn_iterations=1)
    optimize_pose_graph(graph, one, compiled=compiled)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        optimize_pose_graph(graph, one, compiled=compiled)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return dict(
        kernel_launches=sum(e.count for e in ka if e.key in KERNEL_LAUNCHES),
        graph_launches=sum(e.count for e in ka if e.key in GRAPH_LAUNCHES),
        device_kernels=device_kernel_count(ka))


def dense_solve_forms(graph, params):
    """``params``' dense solve of ``graph`` on both forms: compiled=False,
    then the first captured call (the capture) apart and one replay under
    sync-debug "error". Returns (results by form, seconds, replays
    checked)."""
    import torch

    from tpu_slam_torch.graph.pose_graph import optimize_pose_graph

    res, secs = {}, {}
    for label, compiled in (("eager", False), ("first_call", True),
                            ("captured", True)):
        with replays_sync_checked() as chk:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[label] = optimize_pose_graph(graph, params,
                                             compiled=compiled)
            torch.cuda.synchronize()
            secs[label] = time.perf_counter() - t0
    return res, secs, chk.calls


DENSE_GN = 6                   # the dense solve's GN iterations compared
DENSE_NODES = 512              # SLAMConfig()'s node capacity


def compiled_dense(graph, params):
    """The dense solve on config 4's final graph (288 nodes of capacity)
    and on it padded to DENSE_NODES (identity poses), in float32 and
    float64: seconds on both forms, bit-equal, replays checked, the
    graphs' capture seconds and pool bytes (the 288-node float32 one's
    one-iteration graph too: a pool that grew with the iterations would
    hold one H each)."""
    import torch

    from tpu_slam_torch.graph import pose_graph as pg

    gnp = _graph_numpy(graph)
    pad = DENSE_NODES - graph.node_capacity
    padded = dict(gnp, poses=np.concatenate(
        [gnp["poses"], np.broadcast_to(np.eye(4, dtype=np.float32),
                                       (pad, 4, 4))]))
    out = {}
    for nodes, g_np in ((graph.node_capacity, gnp), (DENSE_NODES, padded)):
        for dtype in ("float32", "float64"):
            g = _graph_torch(g_np, graph.poses.device, dtype)
            before = cache_replays(pg._dense_solves)
            res, secs, checked = dense_solve_forms(g, params)
            row = dict(seconds=secs, replays_checked=checked,
                       bit_equal=same_tensors(res["eager"],
                                              res["captured"]),
                       chi2_on_device=res["captured"][1].is_cuda)
            if nodes == graph.node_capacity and dtype == "float32":
                row["gn_iteration"] = {
                    form: gn_iteration_profile(g, params, compiled)
                    for form, compiled in (("eager", False),
                                           ("captured", True))}
            row["graphs"] = cache_use(pg._dense_solves, before)
            out[f"{nodes}_{dtype}"] = row
    return out


def compiled_graph_solves(graph):
    """The config-4 sweep's solve and the final refinement on the run's
    final graph, eager and captured: seconds, the result bit-equal; the
    captured form's launches of one GN iteration from the profiler (the
    runtime's kernel and graph launches, the device's kernels; PERF.md
    holds the eager form's, which are not repeated here). The
    refinement runs its first COMPILED_REFINE_GN GN iterations here (the
    whole refinement runs captured in the slam and slam_resume phases).
    Then the dense solve (``compiled_dense``)."""
    import torch

    from tpu_slam_torch.graph.pose_graph import (GraphSolveParams,
                                                 optimize_pose_graph)

    out = {}
    for name, params in (("sweep", config4().graph),
                         ("final_refine", GraphSolveParams(**dict(
                             FINAL_REFINE,
                             gn_iterations=COMPILED_REFINE_GN)))):
        res, row = {}, {}
        for label, compiled in (("eager", False), ("captured", True)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res[label] = optimize_pose_graph(graph, params,
                                             compiled=compiled)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            row[label] = dict(
                seconds=secs,
                seconds_per_gn_iteration=secs / params.gn_iterations)
            if compiled:
                row[label]["gn_iteration"] = gn_iteration_profile(
                    graph, params, compiled)
        row["bit_equal"] = bool(
            torch.equal(res["eager"][0].poses, res["captured"][0].poses)
            and torch.equal(res["eager"][1], res["captured"][1]))
        out[name] = row
    out["dense"] = compiled_dense(
        graph, GraphSolveParams(gn_iterations=DENSE_GN, solver="dense"))
    return out


def phase_compiled(clouds, gt, run, c4_clouds, c4_gt):
    """The reference's two compiled programs on the card against their
    eager forms: config 2 on the captured step, config 4 through its first
    accepting sweep, the graph solves. Any difference in the bits, or a
    read back inside a captured step, fails."""
    t0 = time.perf_counter()
    c2, c2_same = compiled_config2(clouds, gt)
    t1 = time.perf_counter()
    c4 = compiled_config4(run, c4_clouds, c4_gt)
    t2 = time.perf_counter()
    solves = compiled_graph_solves(run["state"].graph)
    t3 = time.perf_counter()
    emit("compiled", config2=c2, config2_bit_equal=c2_same, config4=c4,
         graph_solves=solves, seconds=t3 - t0,
         part_seconds=dict(config2=t1 - t0, config4=t2 - t1,
                           graph_solves=t3 - t2))
    if not all(c2_same.values()):
        raise AssertionError(f"config 2: captured and eager differ: "
                             f"{c2_same}")
    prof = c2["captured"]["profile"]
    if (prof["host_syncs_per_step"] or prof["dtoh_copies_per_step"]
            or prof["synchronize_calls_per_step"]):
        raise AssertionError(f"a captured config-2 step read back or "
                             f"synchronised: {prof}")
    if not (c4["poses_bit_equal"] and not c4["state_keys_differing"]):
        raise AssertionError(f"config 4: captured and eager differ: "
                             f"poses {c4['poses_bit_equal']}, state "
                             f"{c4['state_keys_differing']}")
    dense = solves.pop("dense")
    if not all(s["bit_equal"] for s in solves.values()):
        raise AssertionError("a captured graph solve differs from the "
                             "eager one")
    for case, row in dense.items():
        # each case: its solve's graph (the 288-node float32 one also its
        # one-iteration profile's), replayed once under sync-debug
        want = 2 if "gn_iteration" in row else 1
        if not (row["bit_equal"] and row["chi2_on_device"]
                and row["replays_checked"] == 1
                and row["graphs"]["captured"] == want):
            raise AssertionError(f"the captured dense solve ({case}): "
                                 f"{row}")


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


def verification_batch(state, cfg, n_pairs=6, pairs=None):
    """The first ICP iteration's NN inputs of a verification batch from the
    slam run's keyframes: the accepted loop pairs (i, j) (or ``pairs``),
    source cloud j moved by the initial guess T_i^-1 T_j, target cloud i."""
    import torch

    from tpu_slam_torch.core import se3

    pairs = sorted(pairs or state.loop_pairs)[:n_pairs]
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


def pcg_work(graph, iters):
    """Bytes and float32 operations ``iters`` CG iterations need on this
    graph: each live edge's J_j and W_e (288 B), its two ends (16 B) and
    its two incidence entries (8 B), each live node's Minv block (144 B),
    list offset (4 B) and x, r, p read and written (144 B), once a chunk;
    an iteration does, a live edge, the difference and the three 6 x 6
    products (222) and its two signed adds into the nodes' sums (12), and,
    a live node, z = Minv r (72) and 84 more for the prior, the damping,
    the three dot products and the updates of x, r and p."""
    edges = int(graph.edge_mask.sum())
    nodes = int(graph.n_nodes)
    nbytes = edges * (288 + 16 + 8) + nodes * (144 + 4 + 144)
    flops = iters * (edges * (222 + 12) + nodes * (72 + 84))
    return nbytes, flops, dict(live_edges=edges, live_nodes=nodes)


def padded_graph(graph, nodes, edges):
    """``graph`` at ``nodes`` node and ``edges`` edge slots: identity poses
    and masked identity edges (index 0) added as padding."""
    gnp = _graph_numpy(graph)
    n_pad = nodes - graph.node_capacity
    e_pad = edges - graph.edge_capacity

    def eyes(k, n):
        return np.broadcast_to(np.eye(k, dtype=np.float32), (n, k, k))

    return _graph_torch(dict(
        gnp, poses=np.concatenate([gnp["poses"], eyes(4, n_pad)]),
        edge_i=np.concatenate([gnp["edge_i"], np.zeros(e_pad, np.int64)]),
        edge_j=np.concatenate([gnp["edge_j"], np.zeros(e_pad, np.int64)]),
        edge_T=np.concatenate([gnp["edge_T"], eyes(4, e_pad)]),
        edge_info=np.concatenate([gnp["edge_info"], eyes(6, e_pad)]),
        edge_mask=np.concatenate([gnp["edge_mask"], np.zeros(e_pad, bool)])),
        graph.poses.device)


def check_pcg_case(name, graph, params, stop_after=None):
    """The chunk kernel against its plain version (``_pcg_iterations``) on
    one chunk of PCG_CHUNK iterations from the CG start of ``graph``'s
    first GN iteration: x, r, p within PCG_RTOL_OF_MAX of each one's
    largest magnitude, the same count of iterations that did work (with
    ``stop_after``, a tolerance that the plain iterations cross after that
    many: an early stop), two launches bit-equal; times (a call resets the
    state and launches the kernel), the kernel's device time, a call in a
    replayed CUDA graph, and the bound from ``pcg_work``."""
    import dataclasses

    import torch

    from tpu_slam_torch.graph import pose_graph as pg
    from tpu_slam_torch.kernels.pcg import pcg_chunk, smem_plan
    from tpu_slam_torch.utils import tracing

    b, diag, terms = pg._build_rhs_and_diag(graph, params)
    Minv, *start = pg._pcg_start(graph, params, b, diag, terms)
    if stop_after is not None:
        r = pg._pcg_iterations(graph, params, terms, Minv, *start,
                               stop_after)[1]
        params = dataclasses.replace(
            params, cg_tolerance=float(pg._dot(r, r)) * 1.01)
    inc = pg.node_incidence(graph)
    counter = tracing.device_counter("cg_iters_used", graph.poses.device)
    state = [t.clone() for t in start]

    def kernel():
        for dst, src in zip(state, start):
            dst.copy_(src)
        pcg_chunk(graph.edge_i, graph.edge_j, graph.edge_mask, *inc,
                  terms[1], terms[2], Minv, *state, counter,
                  params.prior_weight, params.damping, params.cg_tolerance,
                  PCG_CHUNK)

    def plain():
        return pg._pcg_iterations(graph, params, terms, Minv, *start,
                                  PCG_CHUNK)

    def used_by(fn):
        c0 = int(counter)
        out = fn()
        return out, int(counter) - c0

    label = f"pcg_chunk {name}"
    _, used = used_by(kernel)
    got = [t.clone() for t in state]
    kernel()
    if not all(torch.equal(a, c) for a, c in zip(got, state)):
        raise AssertionError(f"{label}: two launches differ")
    want, want_used = used_by(plain)
    if used != want_used or not 0 < used <= PCG_CHUNK or (
            (stop_after is None) != (used == PCG_CHUNK)):
        raise AssertionError(f"{label}: {used} iterations, plain "
                             f"{want_used}")
    errs, rel = [], {}
    for vec, a, w in zip("xrp", got, want):
        err = float((a - w).abs().max())
        scale = float(w.abs().max())
        if not err <= PCG_RTOL_OF_MAX * max(scale, 1e-30):
            raise AssertionError(f"{label}: {vec} off by {err} (scale "
                                 f"{scale})")
        errs.append(err)
        rel[vec] = err / max(scale, 1e-30)
    ms = time_ms(kernel, 50)
    clocks = clocks_now()
    plain_ms = time_ms(plain, 5)
    per_kernel, _ = device_time_us(kernel, 20)
    kernel_us = sum(v for k, v in per_kernel.items()
                    if "pcg_chunk_kernel" in k)
    graph_us, graph_error = graph_time_us(kernel)
    nbytes, flops, counts = pcg_work(graph, used)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    copied, _, smem = smem_plan(graph.node_capacity, graph.edge_capacity)
    extra = dict(graph_error=graph_error) if graph_error else {}
    return dict(case=name, node_slots=graph.node_capacity,
                edge_slots=graph.edge_capacity, edges_copied=copied,
                smem_bytes=smem, cg_tolerance=params.cg_tolerance,
                iterations=used, max_abs_err=max(errs),
                rel_err_of_max=rel, ms=ms, plain_ms=plain_ms,
                kernel_device_us=kernel_us or None,
                device_events={k[:60]: t for k, t in per_kernel.items()},
                graph_us_per_call=graph_us, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, flops=flops, clocks_after_timing=clocks,
                **counts, **extra)


def pcg_solve_ms(graphs, params, reps=3):
    """``params``' captured PCG solve of each graph (name -> graph) with
    the chunk kernel and with the plain iterations (``pg._chunk_kernel``
    swapped out): ms a solve after the capture, the kernel's timed
    ``reps`` times, the plain path's once."""
    import torch

    from tpu_slam_torch.graph import pose_graph as pg

    fits, out = pg._chunk_kernel, {}
    try:
        for name, graph in graphs.items():
            row = {}
            for label, on, n in (("kernel", True, reps),
                                 ("plain_iterations", False, 1)):
                pg._chunk_kernel = fits if on else (lambda g: False)
                pg._solves.clear()          # a solve keeps the path it chose
                pg.optimize_pose_graph(graph, params)          # the capture
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(n):
                    pg.optimize_pose_graph(graph, params)
                torch.cuda.synchronize()
                row[label] = (time.perf_counter() - t0) / n * 1e3
            out[name] = row
    finally:
        pg._chunk_kernel = fits
        pg._solves.clear()
    return out


def phase_pcg_kernel(run):
    """The PCG's chunk kernel against the plain iterations on config 4's
    final graph (288 node and 1,024 edge slots) at cg_tolerance 1e-8 and
    with a tolerance that stops it early, and on that graph padded to the
    default SLAMConfig's 512 and 2,048 (whose copy of the edge matrices
    holds fewer slots than there are live edges); then config 4's sweep
    solve of both graphs, captured, with the kernel and with the plain
    iterations."""
    import dataclasses

    graph = run["state"].graph
    padded = padded_graph(graph, 512, 2048)
    params = dataclasses.replace(config4().graph, cg_tolerance=1e-8)
    cases = [check_pcg_case("config4_288x1024", graph, params),
             check_pcg_case("config4_288x1024_early_stop", graph, params,
                            stop_after=4),
             check_pcg_case("config4_padded_512x2048", padded, params)]
    solves = pcg_solve_ms({"config4_288x1024": graph,
                           "config4_padded_512x2048": padded},
                          config4().graph)
    emit("kernels", kernels=["pcg_chunk"], cases=cases, solve_ms=solves,
         check=f"x, r, p within {PCG_RTOL_OF_MAX} of their largest "
               "magnitude, iterations equal, two launches bit-equal")
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


def raster_register(src, tgt, init_T=None, compiled=True):
    """The raster tier of config 1: a coarse call (leaf 1.0), then a fine
    call (leaf 0.5) from its result, both with world z on window x, each
    the captured program (``compiled``, the default) or the host-exit
    form. Returns (coarse result, fine result)."""
    import torch

    from tpu_slam_torch.registration.icp import icp_raster

    _, coarse, fine = config1_params()
    origin = torch.tensor(C1_ORIGIN, device=src.points.device)
    r0 = icp_raster(src, tgt, init_T=init_T, params=coarse,
                    origin_world=origin, axis_perm=C1_PERM,
                    compiled=compiled, **C1_COARSE)
    return r0, icp_raster(src, tgt, init_T=r0.T, params=fine,
                          origin_world=origin, axis_perm=C1_PERM,
                          compiled=compiled, **C1_FINE)


def brute_register(src, tgt, init_T=None, compiled=True):
    from tpu_slam_torch.registration.icp import icp

    return icp(src, tgt, init_T=init_T, params=config1_params()[0],
               compiled=compiled)


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
        graph_launches=sum(e.count for e in ka if e.key in GRAPH_LAUNCHES),
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
    reset_launches(icp_terms_raster, nearest_neighbors)
    out, rate = {}, {}
    for label, (src, tgt, xi) in pairs.items():
        at_start = (launches_of(icp_terms_raster),
                    launches_of(nearest_neighbors))
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
                                      lambda: launches_of(icp_terms_raster))
        prof_b = registration_profile(lambda: brute_register(src, tgt),
                                      lambda: launches_of(nearest_neighbors))
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
            icp_terms_launches=launches_of(icp_terms_raster) - at_start[0],
            nn_search_launches=launches_of(nearest_neighbors) - at_start[1])

    # the tier icp_auto routes each size to, seen from the kernel counters
    auto = {}
    _, _, fine = config1_params()
    origin = torch.tensor(C1_ORIGIN, device=dev)
    for label, (src, tgt, _) in pairs.items():
        nn0 = launches_of(nearest_neighbors)
        icp_auto(src, tgt, params=fine, origin_world=origin,
                 axis_perm=C1_PERM, **C1_FINE)
        auto[label] = ("brute" if launches_of(nearest_neighbors) > nn0
                       else "raster")
    torch.cuda.synchronize()
    launches = launches_of(icp_terms_raster)
    nn_launches = launches_of(nearest_neighbors)
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
    return launches, nn_launches, pairs, rate


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
    library_ms = library_us = library_graph_us = None
    if library is not None:
        lib = [time_ms(library, 100), time_ms(library, 100)]
        library_ms = sum(lib) / 2
        library_us = device_us_total(library, 20)
        # a second device reading, which the profiler cannot drop: the
        # call replayed in a CUDA graph
        library_graph_us, _ = graph_time_us(library)
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
                library_graph_us_per_call=library_graph_us,
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
    tab200 = t(rng.normal(size=(2048, 200)).astype(np.float32))
    idx8k = t(rng.integers(0, 2048, 8192).astype(np.int32))
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
        # the row sum and the one-hot on the scalar path (the misaligned
        # table) and at 200 columns (float4s, lanes walking two units)
        check_gather_case("row_sum_misaligned_32k_of_4k", G.gather_row_sum,
                          G.gather_row_sum_plain, (tab4k_off, idx32k)),
        check_gather_case("row_sum_200_cols_8k_of_2k", G.gather_row_sum,
                          G.gather_row_sum_plain, (tab200, idx8k)),
        check_gather_case("onehot_bf16_misaligned_32k_of_4k", G.onehot_gather,
                          G.onehot_gather_plain, (tab4k_off, idx32k, True)),
        check_gather_case("onehot_f32_200_cols_8k_of_2k", G.onehot_gather,
                          G.onehot_gather_plain, (tab200, idx8k),
                          library=lambda: tab200.index_select(0, idx8k)),
    ]
    emit("kernels", kernels=[k.__name__ for k in kernels], cases=cases,
         check="bit-equal to the plain version")
    # each kernel takes its float4 path on the aligned tables of widths a
    # multiple of 4 and its scalar path on the others (the profiler's
    # kernel names, where it saw the kernel)
    for c in cases:
        if not c["kernel_names"]:
            continue
        vec = c["table"][1] % 4 == 0 and c["table_offset_bytes"] == 0
        if not all(("_kernel<true" in k) == vec for k in c["kernel_names"]):
            raise AssertionError(f"{c['kernel']} {c['case']}: path "
                                 f"{c['kernel_names']}")
    return launches, cases


# ---------------------------------------------------------------------------
# The dense engine's options: occupancy eviction and deskew
# ---------------------------------------------------------------------------

def options_room_case(device):
    """tests/test_deskew_occupancy.py's dynamic-object room on the card:
    a box seen in the first two scans, then ten scans without it; the
    occupancy layer must clear the box's cells and keep the room's."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam_torch.registration.ndt import NDTParams

    box_lo, box_hi = np.array([1.5, -0.8, 0.0]), np.array([2.6, 0.8, 1.4])
    world_with = syn.make_room(size=(12.0, 9.0, 3.0),
                               boxes=[(box_lo, box_hi)])
    world_without = syn.make_room(size=(12.0, 9.0, 3.0))
    T = np.eye(4)
    T[:3, 3] = [-2.0, 0.0, 1.3]
    rng = np.random.default_rng(0)

    def scan(world):
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, noise_std=0.005, rng=rng, device=device)
        return PointCloud.from_points_host(pts[valid], capacity=8192,
                                           device=device)

    cfg = OdometryConfig(
        scan_capacity=4096, downsample_leaf=0.25, map_leaf=0.4,
        map_half_extent=8.0, map_capacity=16384,
        ndt=NDTParams(max_iterations=15, window_dims=(32, 32, 16)),
        pyramid_factor=2, use_occupancy=True, occupancy_steps=64,
        occupancy_max_range=15.0, occupancy_evict_below=-1.0,
        min_insert_fraction=0.0)
    odo = DenseLidarOdometry(cfg, device=device)
    spec = cfg.map_spec()

    def box_cells(grid):
        wx, wy, wz = grid.dims
        rows = grid.rows.cpu().numpy()
        occ = rows[:, 0] > 0
        idx = np.arange(rows.shape[0])
        cc = np.stack([idx // (wy * wz), (idx // wz) % wy, idx % wz], 1)
        origin_w = (np.asarray(spec.origin)
                    + grid.origin_cell.cpu().numpy() * spec.leaf)
        centers = origin_w + (cc + 0.5) * spec.leaf
        inside = ((centers > box_lo - 0.2) & (centers < box_hi + 0.2)).all(1)
        return int(np.sum(occ & inside)), int(np.sum(occ))

    state = odo.init_state(scan(world_with), T)
    state = odo.step(state, scan(world_with))
    before, total_before = box_cells(state.grid)
    matched = []
    for _ in range(10):
        state = odo.step(state, scan(world_without))
        matched.append(float(state.last_metrics[1]))
    after, total_after = box_cells(state.grid)
    out = dict(box_cells_before=before, box_cells_after=after,
               cells_before=total_before, cells_after=total_after,
               evicted=int(odo.n_evicted), min_matched_fraction=min(matched))
    if not (before > 10 and after <= 0.3 * before
            and total_after > 0.6 * total_before):
        raise AssertionError(f"occupancy eviction: {out}")
    return out


def options_deskew_case(device, n_azimuth=4096):
    """tests/test_deskew_occupancy.py's moving capture at 65,536 rays: each
    block of 16 azimuths captured from the pose interpolated at its time,
    deskewed into the sweep-end frame on the card; median distance of the
    points (through the end pose) to the office's surfaces."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.ingest.deskew import deskew_cloud

    world = syn.default_office()
    T_start = syn.se2_pose(0.0, 0.0, 0.0, z=1.2)
    T_end = syn.se2_pose(0.4, 0.1, 0.08, z=1.2)
    xi = se3.log(torch.tensor(np.linalg.inv(T_start) @ T_end,
                              dtype=torch.float32))
    dirs = syn.vlp16_directions(n_azimuth)             # azimuth-major
    frac = np.arctan2(dirs[:, 1], dirs[:, 0]) % (2 * np.pi) / (2 * np.pi)
    pts = np.zeros((dirs.shape[0], 3), np.float32)
    valid = np.zeros(dirs.shape[0], bool)
    per = 16 * 16
    for c in range(dirs.shape[0] // per):
        sel = slice(c * per, (c + 1) * per)
        a = float(np.median(frac[sel]))
        T_a = T_start @ se3.exp(a * xi).double().numpy()
        dw = dirs[sel] @ T_a[:3, :3].T
        r = world.raycast(np.broadcast_to(T_a[:3, 3], dw.shape), dw)
        v = np.isfinite(r)
        pts[sel] = dirs[sel] * np.where(v, r, 0.0)[:, None]
        valid[sel] = v
        frac[sel] = a

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                               device=device)

    args = (PointCloud(points=f32(pts),
                       mask=torch.as_tensor(valid, device=device)),
            f32(frac), f32(T_start), f32(T_end))
    fixed = deskew_cloud(*args).points.cpu().numpy()
    ms = time_ms(lambda: deskew_cloud(*args), 20)
    o, _, _, nrm = world._arrays()

    def surface_dist(body_pts):
        w = body_pts[valid] @ T_end[:3, :3].T + T_end[:3, 3]
        d = np.abs(np.einsum("nkd,kd->nk", w[:, None, :] - o[None], nrm))
        return float(np.median(d.min(axis=1)))

    out = dict(rays=int(dirs.shape[0]), points=int(valid.sum()),
               median_surface_dist_deskewed_m=surface_dist(fixed),
               median_surface_dist_raw_m=surface_dist(pts), deskew_ms=ms)
    if not (out["median_surface_dist_deskewed_m"] < 2e-3
            and out["median_surface_dist_deskewed_m"]
            < 0.05 * out["median_surface_dist_raw_m"]):
        raise AssertionError(f"deskew: {out}")
    return out


def phase_options(clouds, gt):
    """The room and the moving capture, then config 2 with use_occupancy
    from two fresh engines (bit-identical), then its step profile."""
    import dataclasses

    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    room = options_room_case("cuda")
    desk = options_deskew_case("cuda")
    cfg = dataclasses.replace(config2(), use_occupancy=True)
    runs = []
    plain_before = ndt_terms_plain.launches
    for _ in range(2):
        engine = DenseLidarOdometry(cfg)
        torch.cuda.synchronize()
        reset_launches(ndt_terms)
        t0 = time.perf_counter()
        poses, log = engine.run(clouds, init_pose=gt[0])
        runs.append(dict(poses=poses, summary=log.summary(),
                         seconds=time.perf_counter() - t0,
                         launches=launches_of(ndt_terms),
                         evicted=int(engine.n_evicted)))
    if ndt_terms_plain.launches != plain_before:
        raise AssertionError("the options path ran the plain terms version")
    first = runs[0]
    if first["launches"] <= 0:
        raise AssertionError("config 2 with occupancy launched no ndt_terms")
    if not np.all(np.isfinite(first["poses"])):
        raise AssertionError("config 2 with occupancy: non-finite poses")
    same = (np.array_equal(runs[0]["poses"], runs[1]["poses"])
            and runs[0]["evicted"] == runs[1]["evicted"])
    steps = len(clouds) - 1
    emit("options", room=room, deskew=desk, config2_occupancy=dict(
        scans=len(clouds), ate_m=ate_rmse(first["poses"], gt, align=False),
        mean_matched_fraction=first["summary"]["mean_matched_fraction"],
        mean_iterations=first["summary"]["mean_iterations"],
        evicted_cells=first["evicted"],
        ndt_terms_launches=first["launches"],
        ndt_terms_launches_per_step=first["launches"] / steps,
        scans_per_s=[len(clouds) / r["seconds"] for r in runs],
        p50_step_s=first["summary"]["p50_wall_time_s"],
        bit_identical_rerun=same))
    if not same:
        raise AssertionError("config 2 with occupancy: reruns differ")
    phase_profile(engine, clouds, gt, label="profile_occupancy")
    return first["launches"]


# ---------------------------------------------------------------------------
# Config 3: scan-to-map NDT on the sparse voxel map (bench.py:349-604)
# ---------------------------------------------------------------------------

def config3_workload(device):
    """bench_ndt_register's workload: the grid city's surfaces sampled at
    0.15 m into a 0.5 m map of +-128 m (capacity 524,288), one VLP-16 street
    scan at 8,192 azimuths downsampled at 0.2 m (the fine scan, cut to
    20,480 rows) and at 1.0 m (the coarse stage's scan)."""
    import torch

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.kernels.downsample import voxel_downsample
    from tpu_slam_torch.kernels.voxel_hash import VoxelGridSpec
    from tpu_slam_torch.mapping.voxel_map import build_map_host

    t0 = time.perf_counter()
    world = syn.dense_city(extent=200.0, seed=0)
    surf = syn.sample_world_surface(world, spacing=0.15, noise_std=0.01,
                                    seed=1)
    map_spec = VoxelGridSpec.centered(leaf=0.5, half_extent=128.0)
    vmap = build_map_host(surf, map_spec, capacity=524288, device=device)
    map_s = time.perf_counter() - t0
    T_pose = syn.se2_pose(-4.0, -4.0, 0.3, z=1.8)
    pts, valid = syn.simulate_vlp16_revolution(
        world, T_pose, n_azimuth=8192, max_range=75.0, noise_std=0.01,
        rng=np.random.default_rng(0), device=device)
    cloud = PointCloud.from_points_host(pts[valid], capacity=131072,
                                        device=device)
    scan = voxel_downsample(
        cloud, VoxelGridSpec.centered(leaf=0.2, half_extent=102.0),
        capacity=65536)
    scan = PointCloud(points=scan.points[:20480], mask=scan.mask[:20480])
    cscan = voxel_downsample(
        cloud, VoxelGridSpec.centered(leaf=1.0, half_extent=102.0),
        capacity=16384)
    return dict(surf=surf, vmap=vmap, map_spec=map_spec, cloud=cloud,
                scan=scan, cscan=cscan, map_s=map_s,
                seconds=time.perf_counter() - t0,
                Tw=torch.as_tensor(T_pose, dtype=torch.float32,
                                   device=device))


def config3_params():
    """bench_ndt_register's (coarse, fine) NDTParams."""
    from tpu_slam_torch.registration.ndt import NDTParams

    return (NDTParams(max_iterations=3, coarse_iterations=2,
                      max_corr_dist=4.0, window_dims=C3_COARSE),
            NDTParams(max_iterations=5, coarse_iterations=0, tolerance=1e-3,
                      min_voxel_count=3.0, rebin_iters=5,
                      window_dims=C3_FINE))


def phase_config3(w):
    """The production two-level solve on config 3 at full size, the stage
    times, then ndt_terms against its plain version on the solve's own
    coarse, fine and far rasters. Returns (launches, kernel cases)."""
    import json as _json
    import math as _math
    import pathlib

    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                                  ndt_terms, ndt_terms_plain)
    from tpu_slam_torch.mapping.dense_map import (centered_origin_cell,
                                                  empty_grid, grid_insert,
                                                  grid_ndt_field)
    from tpu_slam_torch.mapping.voxel_map import coarse_spec_of, coarsen_map
    from tpu_slam_torch.registration.ndt import ndt_field, ndt_register

    vmap, map_spec, scan, cscan, Tw = (w["vmap"], w["map_spec"], w["scan"],
                                       w["cscan"], w["Tw"])
    dev = Tw.device
    n_vox = int(vmap.n_occupied())
    n_scan = int(scan.count())
    cparams, fparams = config3_params()
    cspec = coarse_spec_of(map_spec, 4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cmap = coarsen_map(vmap, map_spec, 4)
    cfield = ndt_field(cmap, cspec, cparams, center=Tw[:3, 3])
    field = ndt_field(vmap, map_spec, fparams, center=Tw[:3, 3])
    torch.cuda.synchronize()
    fields_s = time.perf_counter() - t0

    def register(s, cs, init_T):
        r0 = ndt_register(cs, cfield, cspec, init_T=init_T, params=cparams)
        return r0, ndt_register(s, field, map_spec, init_T=r0.T,
                                params=fparams, far_field=cfield,
                                far_spec=cspec)

    E = se3.exp(torch.tensor(C3_XI, dtype=torch.float32, device=dev))
    src, csrc = scan.transform(se3.inverse(E)), cscan.transform(
        se3.inverse(E))
    T_true = Tw @ E
    plain_before = ndt_terms_plain.launches
    torch.cuda.synchronize()
    reset_launches(ndt_terms)
    r0, res = register(src, csrc, Tw)
    launches = launches_of(ndt_terms)
    if ndt_terms_plain.launches != plain_before:
        raise AssertionError("config 3 ran the plain terms version")
    if launches <= 0:
        raise AssertionError("config 3 launched no ndt_terms kernel")
    err = se3.log(se3.inverse(T_true) @ res.T)
    err_mm = float(torch.linalg.vector_norm(err[:3])) * 1e3
    frac = float(res.matched_fraction)
    # coverages as the bench computes them: scan points (at the truth)
    # inside the fine window, and inside it or the far tier's
    sane = scan.sanitize()
    pw = se3.apply(T_true, sane.points)
    rel = (pw - Tw[:3, 3]).abs()
    half = torch.tensor([d / 2 * 0.5 for d in C3_FINE], device=dev)
    inwin = (rel < half).all(1) & sane.mask
    infar = (rel < torch.tensor(C3_COARSE, dtype=torch.float32,
                                device=dev)).all(1) & sane.mask
    coverage = int(inwin.sum()) / max(n_scan, 1)
    objective_coverage = int((inwin | infar).sum()) / max(n_scan, 1)

    # registrations/s: the bench's loop (each init the last result moved
    # by (0.15 sin i, 0.1 cos i)), CUDA events over C3_REGISTRATIONS
    def reg_loop(k):
        Tc = Tw
        for i in range(k):
            Ti = Tc.clone()
            Ti[0, 3] += _math.sin(i) * 0.15
            Ti[1, 3] += _math.cos(i) * 0.1
            Tc = register(scan, cscan, Ti)[1].T
        return Tc

    reg_loop(3)
    reset_launches(ndt_terms)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    reg_loop(C3_REGISTRATIONS)
    end.record()
    torch.cuda.synchronize()
    reg_ms = start.elapsed_time(end) / C3_REGISTRATIONS
    loop_launches = launches_of(ndt_terms)

    # where one registration's time goes: its wall on the host clock, then
    # the same call under the profiler (device busy time by kernel)
    def one():
        return register(src, csrc, Tw)[1].T

    one()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t1) * 1e6
    per_kernel, prof = device_time_us(one, 1)
    ka = prof.key_averages()
    busy_us = sum(per_kernel.values())
    reg_profile = dict(
        wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
        device_idle_share=1.0 - busy_us / wall_us,
        kernel_launches=sum(e.count for e in ka
                            if e.key == "cudaLaunchKernel"),
        host_syncs=sum(e.count for e in ka
                       if e.key == "aten::_local_scalar_dense"),
        top_device_us=[(k[:80], v) for k, v in sorted(
            per_kernel.items(), key=lambda kv: -kv[1])[:8]])

    # stage times
    center = Tw[:3, 3]
    field_ms = time_ms(lambda: ndt_field(vmap, map_spec, fparams,
                                         center=center), 10)
    surf_cloud = PointCloud.from_points_host(w["surf"],
                                             capacity=len(w["surf"]),
                                             device=dev)
    grid = grid_insert(empty_grid(C3_FINE, field.origin_cell), surf_cloud,
                       map_spec)
    del surf_cloud
    gfield = grid_ndt_field(grid, map_spec, min_voxel_count=3.0)
    grid_field_ms = time_ms(lambda: grid_ndt_field(grid, map_spec,
                                                   min_voxel_count=3.0), 10)
    # the same window from the dense path: valid where both are, and the
    # cells whose validity differs (points within an ulp of a cell face
    # land on either side of it in the two builds)
    g_valid, f_valid = gfield.rows[:, 9] > 0.5, field.rows[:, 9] > 0.5
    both = g_valid & f_valid
    compare = dict(
        field_valid_cells=int(f_valid.sum()),
        grid_field_valid_cells=int(g_valid.sum()),
        valid_cells_differing=int((g_valid != f_valid).sum()),
        max_mean_diff_m=float((gfield.rows[both, :3]
                               - field.rows[both, :3]).abs().max())
        if bool(both.any()) else None)
    dims = field.window_dims
    origin_w = (map_spec.origin_tensor(dev)
                + field.origin_cell.float() * map_spec.leaf)
    slots, n_drop = build_terms_raster(sane.points, sane.mask, Tw, origin_w,
                                       map_spec.leaf, dims, 4)
    raster_dropped = int(n_drop)
    raster_ms = time_ms(lambda: build_terms_raster(
        sane.points, sane.mask, Tw, origin_w, map_spec.leaf, dims, 4), 20)
    wcloud = w["cloud"].transform(Tw)
    grid0 = grid_insert(empty_grid(dims, centered_origin_cell(
        Tw[:3, 3], map_spec, dims, align=4)), wcloud, map_spec)
    insert_ms = time_ms(lambda: grid_insert(grid0, wcloud, map_spec), 10)
    del grid, gfield, grid0

    # ndt_terms on the solve's own rasters: the coarse stage's (at the
    # init), the fine and far tiers' (at the coarse result), each scored
    # at the final pose
    T0 = r0.T
    c_origin = (cspec.origin_tensor(dev)
                + cfield.origin_cell.float() * cspec.leaf)
    cslots, _ = build_terms_raster(csrc.points, csrc.mask, Tw, c_origin,
                                   cspec.leaf, cfield.window_dims,
                                   cparams.raster_q)
    fine, _ = build_terms_raster(src.points, src.mask, T0, origin_w,
                                 map_spec.leaf, dims, fparams.raster_q)
    far, _ = build_terms_raster(src.points, src.mask & ~fine.inside, T0,
                                c_origin, cspec.leaf, cfield.window_dims,
                                fparams.raster_q)
    far_corr = fparams.max_corr_dist * (cspec.leaf / map_spec.leaf)
    gamma_c = cparams.score_temperature * cparams.coarse_temperature_scale
    # the solve's last pose is an optimum, where b's terms cancel; the
    # same raster 2 cm off it (as config 2's cases are scored) shows the
    # error against a gradient that does not vanish
    T_off = se3.retract(res.T, torch.tensor(
        [0.02, -0.01, 0.0, 0.0, 0.0, 0.005], device=dev))
    cases = [check_terms_case("config3_fine_q4", (
                 fine, field.rows, res.T, fparams.score_temperature,
                 fparams.max_corr_dist, dims)),
             check_terms_case("config3_fine_q4_2cm_off", (
                 fine, field.rows, T_off, fparams.score_temperature,
                 fparams.max_corr_dist, dims)),
             check_terms_case("config3_far_q4", (
                 far, cfield.rows, res.T, fparams.score_temperature,
                 far_corr, cfield.window_dims)),
             check_terms_case("config3_coarse_q4", (
                 cslots, cfield.rows, r0.T, gamma_c, cparams.max_corr_dist,
                 cfield.window_dims))]

    out = dict(
        map_voxels=n_vox, map_voxels_reference=C3_MAP_VOXELS,
        scan_points=n_scan, scan_points_reference=C3_REF["scan_points"],
        coarse_scan_points=int(cscan.count()),
        register_err_mm=err_mm, matched_fraction=frac,
        fine_window_coverage=coverage,
        objective_coverage=objective_coverage,
        raster_dropped=raster_dropped,
        raster_dropped_reference=C3_REF["raster_dropped"],
        reference=C3_REF, fine_window_dims=list(C3_FINE),
        coarse_window_dims=list(C3_COARSE),
        fine_origin_cell=field.origin_cell.tolist(),
        coarse_origin_cell=cfield.origin_cell.tolist(),
        iterations=[r0.iterations, res.iterations],
        ndt_terms_launches=launches,
        ndt_terms_launches_per_registration=loop_launches / C3_REGISTRATIONS,
        registrations_per_s=1e3 / reg_ms, register_ms=reg_ms,
        registration_profile=reg_profile,
        stage_field_build_ms=field_ms,
        stage_grid_ndt_field_ms=grid_field_ms,
        stage_raster_build_ms=raster_ms,
        stage_terms_pass_us=cases[0]["kernel_device_us"],
        stage_terms_pass_wrapper_ms=cases[0]["ms"],
        stage_map_insert_ms=insert_ms,
        map_field_vs_grid_field=compare,
        workload_seconds=w["seconds"], map_build_seconds=w["map_s"],
        fields_seconds=fields_s)
    emit("config3", **out)
    emit("kernels", kernels=["ndt_terms"], config=3, cases=cases,
         rtol_of_max=RTOL_OF_MAX)
    path = pathlib.Path(__file__).resolve().parent / "chiprun_out"
    path.mkdir(exist_ok=True)
    (path / "config3.json").write_text(_json.dumps(
        {"phase": "config3", **out, "kernel_cases": cases}, indent=1))
    if n_vox != C3_MAP_VOXELS:
        raise AssertionError(f"map voxels {n_vox} != {C3_MAP_VOXELS}")
    if n_scan < C3_SCAN_FLOOR:
        raise AssertionError(f"scan points {n_scan} < {C3_SCAN_FLOOR}")
    if not err_mm <= C3_ERR_BAR_MM:
        raise AssertionError(f"config 3 error {err_mm} mm > {C3_ERR_BAR_MM}")
    if not frac >= C3_MATCHED_BAR:
        raise AssertionError(f"config 3 matched {frac} < {C3_MATCHED_BAR}")
    if not objective_coverage >= C3_OBJECTIVE_BAR:
        raise AssertionError(f"config 3 objective coverage "
                             f"{objective_coverage} < {C3_OBJECTIVE_BAR}")
    return launches, cases


# ---------------------------------------------------------------------------
# The registration layer's compiled programs: the captured ndt_register
# (config 3, the host engine), JitLidarOdometry's captured step and the
# captured icp_raster (config 1) against their eager forms; the dense
# SLAM's default re-anchor on both forms
# ---------------------------------------------------------------------------

C3_TIMED = 10                  # registrations timed for the p50, each form
C1_TIMED = 5                   # config 1 registrations timed, each form
REANCHOR_SCANS = 40            # the office circle of slam_host


@contextlib.contextmanager
def replays_sync_checked():
    """A context in which every ``CapturedCall`` and ``CapturedStep`` (its
    input copies, its replay and its output copies) runs under
    ``torch.cuda.set_sync_debug_mode("error")``: a read back to the host
    or a synchronisation there raises. Yields a namespace whose ``calls``
    counts the calls checked."""
    import torch

    from tpu_slam_torch.utils.capture import CapturedCall, CapturedStep

    seen = types.SimpleNamespace(calls=0)
    origs = {cls: cls.__call__ for cls in (CapturedCall, CapturedStep)}

    def checker(orig):
        def checked(cap, *args):
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return orig(cap, *args)
            finally:
                torch.cuda.set_sync_debug_mode(prev)
                seen.calls += 1
        return checked

    for cls, orig in origs.items():
        cls.__call__ = checker(orig)
    try:
        yield seen
    finally:
        for cls, orig in origs.items():
            cls.__call__ = orig


def host_ms(fn, n):
    """p50 of ``n`` calls of ``fn`` on the host clock, each synchronised."""
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return float(np.percentile(out, 50))


class PartTimer:
    """``parts(name, fn, *args)`` runs ``fn(*args)`` and adds its wall
    seconds to ``parts.seconds[name]``: where a phase's time goes."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds[name] = time.perf_counter() - t0


def same_tensors(a, b) -> bool:
    """Every tensor of two results or states equal (and equal ints)."""
    import torch

    from tpu_slam_torch.utils.capture import tensors_of

    ta, tb = tensors_of(a), tensors_of(b)
    return len(ta) == len(tb) and all(
        x.shape == y.shape and torch.equal(x, y) for x, y in zip(ta, tb))


def ndt_results_equal(a, b) -> bool:
    """Two NDTResults bit-equal (iterations an int or a () tensor)."""
    import torch

    return (int(a.iterations) == int(b.iterations) and all(
        torch.equal(getattr(a, f), getattr(b, f))
        for f in ("T", "score", "matched_fraction", "converged")))


def terms_us_in_graph(fn, kernel, calls):
    """Device us a call of a terms kernel (kernel + finalizer) inside the
    graphs ``fn`` replays, which make ``calls`` calls (the profiler)."""
    per_kernel, _ = device_time_us(fn, 1)
    return sum(t for k, t in per_kernel.items() if kernel in k) / calls


def compiled_config3(w):
    """Config 3's coarse-then-fine registration on the captured program
    and on the host-exit form: results bit-equal, p50 ms, ndt_terms calls
    and the profiler's launches, reads and H2D copies a registration, the
    input copies' device us, the captures' seconds and memory."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.mapping.voxel_map import coarse_spec_of, coarsen_map
    from tpu_slam_torch.registration import ndt
    from tpu_slam_torch.utils.capture import tensors_of

    vmap, map_spec, scan, cscan, Tw = (w["vmap"], w["map_spec"], w["scan"],
                                       w["cscan"], w["Tw"])
    dev = Tw.device
    cparams, fparams = config3_params()
    cspec = coarse_spec_of(map_spec, 4)
    cfield = ndt.ndt_field(coarsen_map(vmap, map_spec, 4), cspec, cparams,
                           center=Tw[:3, 3])
    field = ndt.ndt_field(vmap, map_spec, fparams, center=Tw[:3, 3])
    E = se3.exp(torch.tensor(C3_XI, dtype=torch.float32, device=dev))
    src = scan.transform(se3.inverse(E))
    csrc = cscan.transform(se3.inverse(E))
    T_true = Tw @ E

    def register(compiled):
        r0 = ndt.compiled_register(csrc, cfield, cspec, init_T=Tw,
                                   params=cparams, compiled=compiled)
        return r0, ndt.compiled_register(
            src, field, map_spec, init_T=r0.T, params=fparams,
            far_field=cfield, far_spec=cspec, compiled=compiled)

    n0 = len(ndt._registers)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    register(True)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    caps = list(ndt._registers.values())[n0:]
    out, res = {}, {}
    for label, compiled in (("eager", False), ("captured", True)):
        with replays_sync_checked() as chk:
            res[label] = register(compiled)
        n1 = launches_of(ndt_terms)
        register(compiled)
        torch.cuda.synchronize()
        calls = launches_of(ndt_terms) - n1
        out[label] = dict(
            ms_p50=host_ms(lambda c=compiled: register(c), C3_TIMED),
            ndt_terms_calls=calls,
            iterations=[int(r.iterations) for r in res[label]],
            profile=registration_profile(
                lambda c=compiled: register(c),
                lambda: launches_of(ndt_terms)),
            replays_checked=chk.calls)
    # what a call copies into the graphs' inputs: the scans, the poses
    # and the fields (the coarse field twice: the coarse solve's field and
    # the fine solve's far tier)
    copies = [(caps[0], (PointCloud(csrc.points, csrc.mask), cfield, Tw,
                         None)),
              (caps[1], (PointCloud(src.points, src.mask), field,
                         res["captured"][0].T, cfield))]

    def copy_in():
        for cap, args in copies:
            for dst, t in zip(cap.inputs, tensors_of(args)):
                dst.copy_(t)

    per_kernel, _ = device_time_us(copy_in, 20)
    r0, r1 = res["captured"]
    err = se3.log(se3.inverse(T_true) @ r1.T)
    return dict(
        bit_equal=all(ndt_results_equal(a, b) for a, b in
                      zip(res["eager"], res["captured"])),
        eager=out["eager"], captured=out["captured"],
        first_call_with_captures_s=first_s,
        graphs=len(caps), capture_s=[c.graph.capture_s for c in caps],
        graph_held_bytes=[c.graph.held_bytes for c in caps],
        graph_pool_bytes=[c.graph.pool_bytes for c in caps],
        calls_per_replay=[c.graph.calls for c in caps],
        ndt_terms_us_per_call_in_graph=terms_us_in_graph(
            lambda: register(True), "ndt_terms", 21),
        input_copy_device_us=sum(per_kernel.values()),
        input_copy_event_ms=time_ms(copy_in, 20),
        input_copy_bytes=sum(t.numel() * t.element_size()
                             for _, args in copies
                             for t in tensors_of(args)),
        register_err_mm=float(torch.linalg.vector_norm(err[:3])) * 1e3,
        matched_fraction=float(r1.matched_fraction))


def compiled_host_odometry(clouds, gt):
    """Config 2's route through LidarOdometry on both forms from fresh
    engines: poses, iterations and matched fractions bit-equal, ATE,
    scans/s, step p50/p95, launches; then six captured steps replayed
    under the profiler (reads, launches, idle share; the eager step's is
    in PERF.md and not repeated)."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.odometry import LidarOdometry
    from tpu_slam_torch.registration import ndt

    cfg = config2()
    out, keep = {}, {}
    for label, compiled in (("eager", False), ("captured", True)):
        eng = LidarOdometry(cfg, compiled=compiled)
        n_graphs = len(ndt._registers)
        n0 = launches_of(ndt_terms)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with replays_sync_checked() as chk:
            poses, _, kept = run_host(eng, clouds, gt[0],
                                      keep=(HOST_PROFILE[0] - 1,))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = launches_of(ndt_terms) - n0
        recs = eng.metrics.records
        wall = np.array([r.wall_time_s for r in recs[1:]]) * 1e3
        keep[label] = (poses, [r.iterations for r in recs],
                       [r.matched_fraction for r in recs])
        out[label] = dict(
            scans_per_s=len(clouds) / dt,
            step_ms_p50=float(np.percentile(wall, 50)),
            step_ms_p95=float(np.percentile(wall, 95)),
            ate_m=ate_rmse(poses, gt, align=False),
            mean_matched=float(np.mean(keep[label][2])),
            ndt_terms_launches_per_scan=launches / (len(clouds) - 1),
            graphs_captured_in_run=len(ndt._registers) - n_graphs,
            replays_checked=chk.calls,
            profile=host_step_profile(
                eng, kept[HOST_PROFILE[0] - 1],
                clouds[HOST_PROFILE[0]:HOST_PROFILE[1]])
            if compiled else None)
    e, c = keep["eager"], keep["captured"]
    return dict(eager=out["eager"], captured=out["captured"],
                bit_equal=dict(poses=bool(np.array_equal(e[0], c[0])),
                               iterations=e[1] == c[1],
                               matched_fractions=e[2] == c[2]))


def compiled_jit_cases(c2_clouds, c2_gt):
    """JitLidarOdometry on host_engine_cases' jit_arc and jit_config2 on
    both forms: every step's state bit-equal, scans/s of a second pass
    (the first one captures), reads inside a captured step (none)."""
    from tpu_slam_torch.pipeline.odometry_jit import JitLidarOdometry

    arc, arc_gt = office_arc(8)
    out = {}
    for case, cfg, clouds, gt in (("jit_arc", odom_cfg(), arc, arc_gt),
                                  ("jit_config2", config2(), c2_clouds,
                                   c2_gt)):
        runs, row = {}, {}
        for label, compiled in (("eager", False), ("captured", True)):
            eng = JitLidarOdometry(cfg, compiled=compiled)
            s0 = eng.init_state(clouds[0], gt[0])
            steps = []
            with replays_sync_checked() as chk:
                s = s0
                for c in clouds[1:]:
                    s = eng.step(s, c)
                    steps.append((s.pose, s.last_delta, s.last_metrics,
                                  s.scan_index))
            runs[label] = (steps, s)

            def again(e=eng, s0=s0, clouds=clouds):
                s = s0
                for c in clouds[1:]:
                    s = e.step(s, c)
            row[label] = dict(scans_per_s=len(clouds) / host_ms(again, 1)
                              * 1e3, replays_checked=chk.calls,
                              graphs=len(eng.graphs))
            del eng, s0
        (es, ef), (cs, cf) = runs["eager"], runs["captured"]
        row["bit_equal"] = bool(
            all(same_tensors(a, b) for a, b in zip(es, cs))
            and same_tensors(ef, cf))
        out[case] = row
    return out


def compiled_config1(pairs):
    """Config 1's raster tier (coarse then fine icp_raster) at each size on
    both forms: results bit-equal, recovery errors, registrations/s (p50
    of C1_TIMED), launches, host syncs and H2D copies a registration; the
    captured form's icp_terms us a call in the graph (PERF.md holds the
    eager form's)."""
    import torch

    from tpu_slam_torch.kernels.icp_terms import icp_terms_raster

    out = {}
    for label, (src, tgt, xi) in pairs.items():
        res, row = {}, {}
        for form, compiled in (("eager", False), ("captured", True)):
            with replays_sync_checked() as chk:
                res[form] = raster_register(src, tgt, compiled=compiled)
            prof = registration_profile(
                lambda c=compiled: raster_register(src, tgt, compiled=c),
                lambda: launches_of(icp_terms_raster))
            row[form] = dict(
                registrations_per_s=1e3 / host_ms(
                    lambda c=compiled: raster_register(src, tgt,
                                                       compiled=c),
                    C1_TIMED),
                recovery_err_mm=recovery_err_mm(xi, res[form][1].T),
                iterations=[int(r.iterations) for r in res[form]],
                replays_checked=chk.calls,
                icp_terms_calls=prof["counted_launches"],
                kernel_launches=prof["kernel_launches"],
                host_syncs=prof["host_syncs"],
                htod_copies=prof["htod_copies"],
                device_idle_share=prof["device_idle_share"])
        row["captured"]["icp_terms_us_per_call"] = terms_us_in_graph(
            lambda: raster_register(src, tgt), "icp_terms",
            row["captured"]["icp_terms_calls"])
        row["bit_equal"] = all(same_tensors(a, b) for a, b in
                               zip(res["eager"], res["captured"]))
        out[label] = row
        torch.cuda.synchronize()
    return out


def dense_reanchor_cfg():
    """slam_host's SLAMConfig on the dense engine, the re-anchor and the
    map rebuild at their defaults (on)."""
    import dataclasses

    from tpu_slam_torch.registration.ndt import NDTParams

    return dataclasses.replace(
        slam_host_cfg(), odometry_engine="dense",
        odometry=odom_cfg(ndt=NDTParams(max_iterations=10,
                                        coarse_iterations=2,
                                        min_voxel_count=3.0,
                                        window_dims=(32, 32, 16)),
                          pyramid_factor=2, insert_downsampled=True))


def dense_reanchor_case(compiled, device="cuda"):
    """The dense SLAM over slam_host's office circle with the default
    re-anchor after each accepted loop sweep: poses, the final state as
    numpy, loops, re-anchors, keyframes, the captured steps' count and the
    windows' rebuild graphs (captured in the run, replays of each)."""
    from tpu_slam_torch.pipeline import slam as slam_mod
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    cfg = dense_reanchor_cfg()
    if not (cfg.reanchor_after_loop and cfg.rebuild_map_after_loop):
        raise AssertionError("the re-anchor case needs SLAMConfig's "
                             "default re-anchor and map rebuild")
    clouds, gt = office_arc(REANCHOR_SCANS, n_azimuth=240, arc_fraction=1.0,
                            device=device)
    slam = slam_mod.SLAMSystem(cfg, device=device, compiled=compiled)
    before = cache_replays(slam_mod._grid_rebuilds)
    state = slam.init_state(gt[0])
    poses, reanchors = [], 0
    t0 = time.perf_counter()
    for c in clouds:
        loops = state.n_loop_closures
        state, _ = slam.step(state, c)
        reanchors += state.n_loop_closures > loops
        poses.append(state.odom.pose.cpu().numpy())
    poses = np.stack(poses)
    return dict(poses=poses, state=slam_state_to_numpy(state),
                seconds=time.perf_counter() - t0,
                loops=state.n_loop_closures, reanchors=reanchors,
                keyframes=state.n_keyframes,
                ate_m=ate_rmse(poses, gt, align=False),
                captured_steps=len(slam.odometry.graphs),
                grid_rebuild=cache_use(slam_mod._grid_rebuilds, before))


def dense_reanchor_compare(device="cuda"):
    """dense_reanchor_case on compiled=False and on compiled=True: poses
    and every key of the final state bit-equal."""
    e = dense_reanchor_case(False, device)
    c = dense_reanchor_case(True, device)
    differ = sorted(k for k in e["state"] if not np.array_equal(
        np.asarray(e["state"][k]), np.asarray(c["state"].get(k))))
    row = {k: c[k] for k in ("loops", "reanchors", "keyframes", "ate_m",
                             "captured_steps", "grid_rebuild")}
    return dict(row, eager_seconds=e["seconds"], captured_seconds=c["seconds"],
                poses_bit_equal=bool(np.array_equal(e["poses"], c["poses"])),
                state_keys_differing=differ)


def phase_compiled_registration(clouds, gt, w3, c1_pairs, c1_rates):
    """The registration layer's compiled programs against their eager
    forms (compiled=False) in this call: config 3, the host odometry on
    config 2's route, JitLidarOdometry's jit_arc and jit_config2, config
    1's raster tier at 8k-256k (and the crossover of the pair_icp phase's
    rates, the raster tier captured against the brute tier), and the
    dense SLAM's default re-anchor. Any difference in the bits, a read or
    a synchronisation inside a captured call, or an accuracy row out of
    its limit fails. Returns the launches of each kernel in the phase."""
    from tpu_slam_torch.kernels.icp_terms import icp_terms_raster
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    kernels = (ndt_terms, icp_terms_raster, nearest_neighbors)
    reset_launches(*kernels)
    t0 = time.perf_counter()
    parts = PartTimer()
    c3 = parts("config3", compiled_config3, w3)
    host = parts("host_odometry", compiled_host_odometry, clouds, gt)
    jit = parts("jit", compiled_jit_cases, clouds, gt)
    c1 = parts("config1", compiled_config1, c1_pairs)
    labels = [label for _, label in C1_SIZES]
    faster = [lb for lb in labels
              if c1_rates[("raster", lb)] > c1_rates[("brute", lb)]]
    launches = {k.__name__: launches_of(k) for k in kernels}
    emit("compiled_registration", config3=c3, host_odometry=host, jit=jit,
         config1=c1, config1_raster_captured_faster_at=faster,
         config1_rates={f"{t}_{lb}": c1_rates[(t, lb)]
                        for t, lb in sorted(c1_rates)},
         launches=launches, seconds=time.perf_counter() - t0,
         part_seconds=parts.seconds)
    failed = []
    if not c3["bit_equal"]:
        failed.append("config 3 captured and eager differ")
    if c3["captured"]["replays_checked"] != 2:
        failed.append("config 3 did not replay both graphs")
    if not (c3["register_err_mm"] <= C3_ERR_BAR_MM
            and c3["matched_fraction"] >= C3_MATCHED_BAR):
        failed.append("config 3 captured accuracy")
    if not all(host["bit_equal"].values()):
        failed.append(f"host odometry differs: {host['bit_equal']}")
    for label in ("eager", "captured"):
        if not abs(host[label]["ate_m"] - HOST_REF["ate_m"]) \
                <= HOST_TOL["ate_m"]:
            failed.append(f"host odometry {label} ATE")
    if host["captured"]["replays_checked"] <= 0:
        failed.append("host odometry replayed no graph")
    for case, row in jit.items():
        if not row["bit_equal"] or row["captured"]["replays_checked"] <= 0:
            failed.append(f"{case} differs or replayed no graph")
    for label, row in c1.items():
        bar = C1_RASTER_BAR_MM if label == "8k" else C1_LARGE_BAR_MM
        if not row["bit_equal"]:
            failed.append(f"config 1 {label} differs")
        if not all(row[f]["recovery_err_mm"] <= bar
                   for f in ("eager", "captured")):
            failed.append(f"config 1 {label} recovery error")
        if row["captured"]["replays_checked"] != 2:
            failed.append(f"config 1 {label} did not replay both graphs")
    if failed:
        raise AssertionError(f"compiled_registration failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# Config 6: bag replay through the CLI (bench.py:824-936)
# ---------------------------------------------------------------------------

def phase_config6(tmpdir):
    """VLP-16 packets along config 2's route -> pcap -> revolutions ->
    rosbag with TF ground truth, then one command: the port's run_odometry
    --bag --engine dense with the bench's --set list. The CLI's wall time
    is the bench's (bag -> dataset conversion + replay); the conversion and
    the odometry are timed apart, as is the pcap -> bag step before it."""
    import io
    import os

    import torch

    from tpu_slam_torch.cli.run_odometry import main as run_odometry
    from tpu_slam_torch.core import se3
    from tpu_slam_torch.ingest import rosbag as rb
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.ingest import velodyne as vlp
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    t0 = time.perf_counter()
    world = syn.dense_city(extent=200.0, seed=0)
    route = city_route(C6_POSES)
    el = np.radians(vlp.VLP16_ELEVATIONS_DEG)
    n_az = 4096                                        # 65,536 rays a scan
    az = np.arange(n_az) * (360.0 / n_az)
    az_r = np.radians(az)[:, None]
    dirs = np.stack([np.cos(el)[None, :] * np.cos(az_r),
                     np.cos(el)[None, :] * np.sin(az_r),
                     np.broadcast_to(np.sin(el)[None, :], (n_az, 16))],
                    axis=2)
    rng = np.random.default_rng(0)
    all_pkts, pkt_times = [], []
    for k, T in enumerate(route):
        dirs_w = dirs.reshape(-1, 3) @ T[:3, :3].T
        r = world.raycast(np.broadcast_to(T[:3, 3], dirs_w.shape), dirs_w,
                          75.0, device="cuda").reshape(n_az, 16)
        r = np.where(np.isfinite(r), r + rng.normal(0, 0.01, r.shape), 0.0)
        pkts = vlp.encode_packets(az, r, start_time_s=100.0 + k)
        all_pkts.append(pkts)
        pkt_times.append(100.0 + k + np.arange(pkts.shape[0]) * 1e-3)
    pcap_path = os.path.join(tmpdir, "seq.pcap")
    vlp.write_pcap(pcap_path, np.concatenate(all_pkts),
                   timestamps_s=np.concatenate(pkt_times))
    synth_s = time.perf_counter() - t0

    t1 = time.perf_counter()
    stream = vlp.VelodyneStream(min_range=0.4, max_range=40.0)
    revs = []
    for _ts, payload in vlp.read_pcap(pcap_path):
        stream.push(np.frombuffer(payload, np.uint8)[None])
        while (rev := stream.pop()) is not None:
            revs.append(rev)
    if (rev := stream.flush()) is not None:
        revs.append(rev)
    revs = revs[:len(route)]
    bag_path = os.path.join(tmpdir, "seq.bag")
    with rb.BagWriter(bag_path) as wr:
        for k, (rev, T) in enumerate(zip(revs, route)):
            t = 100.0 + k
            q = se3.quat_from_matrix(torch.as_tensor(
                T[:3, :3], dtype=torch.float32)).numpy()
            tf = rb.TransformStamped(
                stamp=t - 0.01, frame_id="odom", child_frame_id="velodyne",
                translation=T[:3, 3].copy(), rotation=q.astype(np.float64))
            wr.write("/tf", "tf2_msgs/TFMessage",
                     rb.serialize_tf_message([tf]), t - 0.01)
            wr.write("/velodyne_points", "sensor_msgs/PointCloud2",
                     rb.serialize_pointcloud2(rev.points, t, "velodyne"), t)
    pcap_to_bag_s = time.perf_counter() - t1

    argv = ["--bag", bag_path, "--bag-gt-frame", "odom", "--json",
            "--engine", "dense", "--input-capacity", "65536"]
    for s in C6_SETS:
        argv += ["--set", s]
    plain_before = ndt_terms_plain.launches
    buf = io.StringIO()
    torch.cuda.synchronize()
    reset_launches(ndt_terms)
    t2 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_odometry(argv)
    wall = time.perf_counter() - t2
    launches = launches_of(ndt_terms)
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    n = rec["n_scans"]
    out = dict(
        revolutions=len(revs), n_scans=n, ate_m=rec.get("ate_rmse_m"),
        rpe_trans_m=rec.get("rpe_trans_m"),
        rpe_rot_rad=rec.get("rpe_rot_rad"),
        mean_matched_fraction=rec.get("mean_matched_fraction"),
        wall_s=wall, scans_per_s_wall=n / wall,
        bag_convert_s=rec["bag_convert_s"], odometry_s=rec["odometry_s"],
        convert_share_of_wall=rec["bag_convert_s"] / wall,
        synthesize_s=synth_s, pcap_to_bag_s=pcap_to_bag_s,
        host_conversion_share=(pcap_to_bag_s + rec["bag_convert_s"])
        / (pcap_to_bag_s + wall),
        pcap_bytes=os.path.getsize(pcap_path),
        bag_bytes=os.path.getsize(bag_path), ndt_terms_launches=launches,
        reference=dict(n_scans=24, ate_m=0.0706, rpe_trans_m=0.0038,
                       wall_s=71.6))
    emit("config6", **out)
    if ndt_terms_plain.launches != plain_before:
        raise AssertionError("config 6 ran the plain terms version")
    if launches <= 0:
        raise AssertionError("config 6 launched no ndt_terms kernel")
    if n != C6_SCANS:
        raise AssertionError(f"config 6: {n} scans, not {C6_SCANS}")
    if not out["ate_m"] <= C6_ATE_BAR_M:
        raise AssertionError(f"config 6 ATE {out['ate_m']} > {C6_ATE_BAR_M}")
    if not out["rpe_trans_m"] <= C6_RPE_BAR_M:
        raise AssertionError(f"config 6 RPE {out['rpe_trans_m']} > "
                             f"{C6_RPE_BAR_M}")
    return launches


# ---------------------------------------------------------------------------
# The host engine: LidarOdometry on the sparse voxel map, JitLidarOdometry,
# SLAMSystem(odometry_engine="host")
# ---------------------------------------------------------------------------

# The reference's LidarOdometry on config 2's route (the 24 scans of
# city_scans, config2()'s OdometryConfig) on a CPU, its Pallas terms pass
# replaced by the per-neighbour code of ndt_terms_raster_reference run over
# the raster's occupied slots (PERF.md section 2). The engine loses the
# route in the turn (scan 8) there too; the card is held within HOST_TOL
# of both numbers.
HOST_REF = dict(ate_m=14.115393997877225, matched=0.4373091359933217)
HOST_TOL = dict(ate_m=0.02, matched=0.02)
HOST_PROFILE = (WARMUP_SCANS, WARMUP_SCANS + 6)     # scans replayed
# the reference's own test bars (tests/test_outdoor.py, test_pipeline.py,
# test_odometry_jit.py, test_deskew_occupancy.py). They were set on the
# reference's CPU path, the sparse one (terms_impl "xla"); on its kernel
# path the reference itself loses the outdoor ring and its pyramid gains
# nothing, and point-to-point ICP on the office arc misses icp_plane's
# bar: there the card is held to the reference's own numbers from its CPU
# run (tests/test_torch_host_reference.py --cases), within
# KERNEL_PATH_TOL_M (ICP_POINT_TOL_M for icp_point)
RING_WORST_BAR_M = 0.5
ARC_ICP_ATE_BAR_M = 0.12
REF_KERNEL_PATH = dict(ring_worst_m=11.562442779541016,
                       pyramid_worst_m={0: 15.785445213317871,
                                        4: 15.798905372619629})
KERNEL_PATH_TOL_M = 0.1
REF_ICP_POINT_ATE_M = 0.32980762605859365
ICP_POINT_TOL_M = 0.005
ARC_JIT_ATE_BAR_M = 0.08
HALL_ATE_BAR_M = 0.15
SLAM_HOST_ATE_BAR_M = 0.12
SLAM_HOST_MIN_KF = 10
SLAM_HOST_RESUME_AT = 20


def worst_translation_m(poses, gt):
    """Largest |log(gt^-1 T)|_t over a run (the reference's outdoor bar)."""
    import torch

    from tpu_slam_torch.core import se3

    d = np.linalg.inv(gt) @ np.asarray(poses, np.float64)
    xi = se3.log(torch.as_tensor(d, dtype=torch.float32))
    return float(torch.linalg.vector_norm(xi[:, :3], dim=1).max())


def run_host(engine, clouds, init_pose, keep=()):
    """Steps over the clouds: (poses (N, 4, 4), final state, {k: state
    after scan k for k in keep})."""
    import torch

    state = engine.init_state(init_pose)
    poses, kept = [], {}
    for k, c in enumerate(clouds):
        state, _ = engine.step(state, c)
        poses.append(state.pose)
        if k in keep:
            kept[k] = state
    return torch.stack(poses).cpu().numpy(), state, kept


def host_terms_args(engine, state, cloud):
    """ndt_terms's inputs on the host engine's fine field: the field of
    ``state``'s map centred on its pose, the scan binned at the predicted
    pose and scored 2 cm off it."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.kernels.ndt_terms import build_terms_raster
    from tpu_slam_torch.registration.ndt import ndt_field

    cfg, spec = engine.config, engine.map_spec
    dev = engine.device
    field = ndt_field(state.vmap, spec, cfg.ndt, center=state.pose[:3, 3])
    T0 = state.pose @ engine._clamped_delta(state.last_delta)
    T = se3.retract(T0, torch.tensor([0.02, -0.01, 0.0, 0.0, 0.0, 0.005],
                                     device=dev))
    scan = engine.downsample(cloud)
    origin_w = (spec.origin_tensor(dev)
                + field.origin_cell.to(torch.float32) * spec.leaf)
    slots, _ = build_terms_raster(scan.points, scan.mask, T0, origin_w,
                                  spec.leaf, field.window_dims,
                                  cfg.ndt.raster_q)
    return (slots, field.rows, T, cfg.ndt.score_temperature,
            cfg.ndt.max_corr_dist, field.window_dims)


def host_step_profile(engine, state, clouds):
    """Replays the steps from ``state`` over ``clouds``: the host clock
    unprofiled, then under torch.profiler for the device's busy time,
    kernel launches, device->host reads (copies and scalar reads) and
    ndt_terms calls a step."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import KERNEL_NAMES, ndt_terms

    def replay():
        s = state
        for c in clouds:
            s, _ = engine.step(s, c)
        torch.cuda.synchronize()

    replay()
    n0 = launches_of(ndt_terms)
    t0 = time.perf_counter()
    replay()
    wall_us = (time.perf_counter() - t0) * 1e6
    terms_calls = launches_of(ndt_terms) - n0
    per_kernel, prof = device_time_us(replay, 1)
    ka = prof.key_averages()
    steps = len(clouds)
    busy = sum(per_kernel.values())

    def count(pred):
        return sum(e.count for e in ka if pred(e.key))

    return dict(
        steps=steps, wall_ms_per_step=wall_us / 1e3 / steps,
        device_busy_ms_per_step=busy / 1e3 / steps,
        device_idle_share=1.0 - busy / wall_us,
        ndt_terms_kernel_ms_per_step=sum(
            t for k, t in per_kernel.items()
            if any(n in k for n in KERNEL_NAMES)) / 1e3 / steps,
        kernel_launches_per_step=count(
            lambda k: k in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cuLaunchKernelEx")) / steps,
        graph_launches_per_step=count(lambda k: k in GRAPH_LAUNCHES) / steps,
        dtoh_reads_per_step=count(lambda k: "Memcpy DtoH" in k) / steps,
        h2d_copies_per_step=count(lambda k: "Memcpy HtoD" in k) / steps,
        scalar_reads_per_step=count(
            lambda k: k == "aten::_local_scalar_dense") / steps,
        ndt_terms_calls_per_step=terms_calls / steps,
        top_device_us_per_step=[
            (k[:80], v / steps) for k, v in
            sorted(per_kernel.items(), key=lambda kv: -kv[1])[:8]])


def phase_host_odometry(clouds, gt):
    """Config 2's route through LidarOdometry at full width, on the kernel
    path (terms_impl="auto"): 24 scans timed synced, then again from a
    fresh engine (bit-identical), then a replay of six steps on the host
    clock and under the profiler. Returns (ndt_terms launches, the fine
    (192, 192, 32) terms args)."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.mapping.voxel_map import insert_cloud
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.odometry import LidarOdometry

    cfg = config2()
    engine = LidarOdometry(cfg)
    plain_before = ndt_terms_plain.launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(ndt_terms)
    insert_cloud.fallbacks = insert_cloud.incremental = 0
    t0 = time.perf_counter()
    poses, state, kept = run_host(engine, clouds, gt[0],
                                  keep=(HOST_PROFILE[0] - 1,))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = launches_of(ndt_terms)
    inserts = dict(incremental=insert_cloud.incremental,
                   fallbacks=insert_cloud.fallbacks)
    builds = engine.field_builds
    peak = torch.cuda.max_memory_allocated()
    records = list(engine.metrics.records)
    if launches <= 0 or ndt_terms_plain.launches != plain_before:
        raise AssertionError("the host engine's main path launched no "
                             "ndt_terms kernel, or ran its plain version")
    if poses.shape != (N_SCANS, 4, 4) or not np.all(np.isfinite(poses)):
        raise AssertionError("host odometry poses are not finite (N, 4, 4)")
    ate = ate_rmse(poses, gt, align=False)
    matched = float(np.mean([r.matched_fraction for r in records]))

    again, _, _ = run_host(LidarOdometry(cfg), clouds, gt[0])
    bit_identical = bool(np.array_equal(again, poses))

    start = kept[HOST_PROFILE[0] - 1]
    args = host_terms_args(engine, start, clouds[HOST_PROFILE[0]])
    prof = host_step_profile(engine, start,
                             clouds[HOST_PROFILE[0]:HOST_PROFILE[1]])
    emit("host_odometry", scans=N_SCANS, rays_per_scan=int(clouds[0].capacity),
         window=list(cfg.ndt.window_dims), seconds=dt,
         scans_per_s=N_SCANS / dt, ate_m=ate,
         reference_ate_m=HOST_REF["ate_m"],
         mean_matched_fraction=matched,
         reference_matched=HOST_REF["matched"],
         mean_iterations=float(np.mean([r.iterations for r in records])),
         matched_by_scan=[round(r.matched_fraction, 4) for r in records],
         field_builds=builds, inserts=inserts,
         voxels_at_end=int(state.vmap.n_occupied()),
         ndt_terms_launches=launches,
         ndt_terms_launches_per_scan=launches / (N_SCANS - 1),
         rerun_bit_identical=bit_identical, profile=prof,
         peak_memory_bytes=peak)
    if not abs(ate - HOST_REF["ate_m"]) <= HOST_TOL["ate_m"]:
        raise AssertionError(f"host odometry ATE {ate} m is not within "
                             f"{HOST_TOL['ate_m']} m of the reference's "
                             f"{HOST_REF['ate_m']} m")
    if not abs(matched - HOST_REF["matched"]) <= HOST_TOL["matched"]:
        raise AssertionError(f"host odometry matched {matched} is not within "
                             f"{HOST_TOL['matched']} of the reference's "
                             f"{HOST_REF['matched']}")
    if not bit_identical:
        raise AssertionError("host odometry rerun differs")
    return launches, args


def ring_world():
    """tests/test_outdoor.py _city_world: outdoor_block(seed=1) with 25
    poles of street furniture."""
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.outdoor_block(seed=1)
    rng = np.random.default_rng(3)
    for _ in range(25):
        x, y = rng.uniform(-28, 28, 2)
        if 10 < math.hypot(x, y) < 28:
            w = rng.uniform(0.2, 0.5)
            h = rng.uniform(2.0, 5.0)
            world.patches += syn.make_room(size=(w, w, h),
                                           center=(x, y)).patches[2:]
    return world


def ring_sequence(world, n, step, radius=15.0, seed=0):
    """tests/test_outdoor.py _ring_sequence: 600 azimuths to 80 m."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    rng = np.random.default_rng(seed)
    clouds, gt = [], []
    for k in range(n):
        a = step * k / radius
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.5)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=600, max_range=80, noise_std=0.02, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=24576,
                                                  device="cuda"))
        gt.append(T)
    return clouds, np.stack(gt)


def outdoor_cfg(**kw):
    """tests/test_outdoor.py OUTDOOR_CFG (1 m map leaf, +-80 m)."""
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.registration.ndt import NDTParams

    base = dict(scan_capacity=8192, downsample_leaf=0.4, map_leaf=1.0,
                map_half_extent=80.0, map_capacity=32768,
                ndt=NDTParams(max_iterations=25, max_corr_dist=2.0))
    return OdometryConfig(**{**base, **kw})


def office_arc(n_poses, n_azimuth=360, radius=2.5, arc_fraction=0.25,
               capacity=16384, device="cuda"):
    """tests/test_pipeline.py _sequence: the office arc."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.default_office()
    rng = np.random.default_rng(0)
    clouds, gt = [], []
    for k in range(n_poses):
        a = 2 * math.pi * arc_fraction * k / max(n_poses - 1, 1)
        T = syn.se2_pose(radius * math.cos(a), radius * math.sin(a),
                         a + math.pi / 2, z=1.2)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=n_azimuth, noise_std=0.01, rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid],
                                                  capacity=capacity,
                                                  device=device))
        gt.append(T)
    return clouds, np.stack(gt)


def odom_cfg(**kw):
    """tests/test_pipeline.py ODOM_CFG."""
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.registration.ndt import NDTParams

    base = dict(scan_capacity=4096, downsample_leaf=0.3, map_leaf=0.5,
                map_half_extent=16.0, map_capacity=16384,
                ndt=NDTParams(max_iterations=25))
    return OdometryConfig(**{**base, **kw})


def hall_case():
    """tests/test_outdoor.py test_scrolling_window_outruns_fixed_grid: a
    64 m hall with aperiodic pillars, 74 scans ramping to 0.5 m a scan."""
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn

    rng = np.random.default_rng(0)
    boxes, x, k = [], -26.0, 0
    while x < 27.0:
        w = 1.0 + 0.5 * (k % 3)
        y0, y1 = (2.0, 3.6) if k % 2 == 0 else (-3.6, -1.8)
        boxes.append((np.array([x, y0, 0.0]), np.array([x + w, y1, 3.0])))
        x += 3.0 + 1.7 * (k % 4)
        k += 1
    world = syn.make_room(size=(64.0, 8.0, 3.0), boxes=boxes)
    xs = np.concatenate([np.cumsum(np.linspace(0.05, 0.5, 10)),
                         2.75 + 0.5 * np.arange(1, 65)]) - 18.0 - 2.75
    clouds, gt = [], []
    for k in range(len(xs)):
        T = syn.se2_pose(float(xs[k]), 0.0, 0.0, z=1.3)
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, max_range=14.0, noise_std=0.01,
            rng=rng)
        clouds.append(PointCloud.from_points_host(pts[valid], capacity=8192,
                                                  device="cuda"))
        gt.append(T)
    return clouds, np.stack(gt)


def room_eviction_case():
    """tests/test_deskew_occupancy.py test_dynamic_object_evicted_from_map:
    two scans of a room with a box, ten of it without, occupancy on.
    Returns the numbers its bars read."""
    import torch

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.kernels.voxel_hash import INVALID_KEY
    from tpu_slam_torch.mapping.voxel_map import voxel_means
    from tpu_slam_torch.pipeline.odometry import LidarOdometry
    from tpu_slam_torch.registration.ndt import NDTParams

    box_lo, box_hi = np.array([1.5, -0.8, 0.0]), np.array([2.6, 0.8, 1.4])
    world_with = syn.make_room(size=(12.0, 9.0, 3.0),
                               boxes=[(box_lo, box_hi)])
    world_without = syn.make_room(size=(12.0, 9.0, 3.0))
    T = np.eye(4)
    T[:3, 3] = [-2.0, 0.0, 1.3]
    rng = np.random.default_rng(0)

    def scan(world):
        pts, valid = syn.simulate_vlp16_revolution(
            world, T, n_azimuth=360, noise_std=0.005, rng=rng)
        return PointCloud.from_points_host(pts[valid], capacity=8192,
                                           device="cuda")

    cfg = odom_cfg(scan_capacity=4096, downsample_leaf=0.25, map_leaf=0.4,
                   map_half_extent=8.0, map_capacity=16384,
                   ndt=NDTParams(max_iterations=15), use_occupancy=True,
                   occupancy_capacity=32768, occupancy_steps=64,
                   occupancy_max_range=15.0, occupancy_evict_below=-1.0,
                   min_insert_fraction=0.0)
    odo = LidarOdometry(cfg)
    state = odo.init_state(T)
    for _ in range(2):
        state, _ = odo.step(state, scan(world_with))

    def box_voxels(vmap):
        means = voxel_means(vmap, cfg.map_spec()).cpu().numpy()
        occ = (vmap.keys != INVALID_KEY).cpu().numpy()
        inside = ((means > box_lo - 0.2) & (means < box_hi + 0.2)).all(1)
        return int(np.sum(occ & inside)), int(np.sum(occ))

    box0, total0 = box_voxels(state.vmap)
    matched = []
    for _ in range(10):
        state, m = odo.step(state, scan(world_without))
        matched.append(m.matched_fraction)
    box1, total1 = box_voxels(state.vmap)
    torch.cuda.synchronize()
    return dict(box_voxels_before=box0, box_voxels_after=box1,
                voxels_before=total0, voxels_after=total1,
                min_matched=min(matched))


def phase_host_engine_cases(c2_clouds, c2_gt):
    """The reference's own tests of the host engine at their sizes, with
    their bars, on the card. Returns (launches by kernel, the outdoor
    ring's 64^3 cube terms args, icp_plane's first NN inputs)."""
    import dataclasses

    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.mapping.voxel_map import (voxel_means,
                                                  voxel_normals_neighborhood)
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.odometry import LidarOdometry
    from tpu_slam_torch.pipeline.odometry_jit import JitLidarOdometry
    from tpu_slam_torch.registration.icp import ICPParams
    from tpu_slam_torch.registration.ndt import NDTParams

    plain_before = (ndt_terms_plain.launches,
                    nearest_neighbors_plain.launches)
    reset_launches(ndt_terms, nearest_neighbors)
    out = {}
    t0 = time.perf_counter()

    # the outdoor ring on both terms paths ("auto": the 64^3 cube window)
    world = ring_world()
    clouds, gt = ring_sequence(world, n=25, step=0.5)
    ring = {}
    for impl in ("auto", "xla"):
        cfg = outdoor_cfg(ndt=NDTParams(max_iterations=25, max_corr_dist=2.0,
                                        terms_impl=impl))
        eng = LidarOdometry(cfg)
        ts = time.perf_counter()
        poses, _, kept = run_host(eng, clouds, gt[0], keep=(9,))
        torch.cuda.synchronize()
        ring[impl] = dict(worst_m=worst_translation_m(poses, gt),
                          ate_m=ate_rmse(poses, gt, align=False),
                          seconds=time.perf_counter() - ts)
        if impl == "auto":
            cube_args = host_terms_args(eng, kept[9], clouds[10])
    out["outdoor_ring"] = ring

    # the pyramid's capture range at 1.5 m a scan, on both terms paths
    clouds, gt = ring_sequence(world, n=12, step=1.5)
    out["pyramid_worst_m"] = {impl: {
        pf: worst_translation_m(run_host(LidarOdometry(outdoor_cfg(
            pyramid_factor=pf, ndt=NDTParams(
                max_iterations=25, max_corr_dist=2.0, terms_impl=impl))),
            clouds, gt[0])[0], gt)
        for pf in (0, 4)} for impl in ("auto", "xla")}

    # the scrolling window outruns the world-fixed grid
    clouds, gt = hall_case()
    hall_cfg = outdoor_cfg(scan_capacity=4096, downsample_leaf=0.3,
                           map_leaf=0.4, map_half_extent=12.8,
                           map_capacity=32768,
                           ndt=NDTParams(max_iterations=20),
                           pyramid_factor=0, scrolling_window=True,
                           rebase_fraction=0.25)
    eng = LidarOdometry(hall_cfg)
    poses, _, _ = run_host(eng, clouds, gt[0])
    offset0 = eng.init_state(gt[0]).map_offset
    fixed, _, _ = run_host(LidarOdometry(dataclasses.replace(
        hall_cfg, scrolling_window=False)), clouds, gt[0])
    out["hall"] = dict(ate_m=ate_rmse(poses, gt, align=False),
                       fixed_grid_ate_m=ate_rmse(fixed, gt, align=False),
                       offset0_x_err=abs(float(offset0[0]) - gt[0][0, 3]))

    # ICP against the voxel means at OdometryConfig()'s capacities
    clouds, gt = office_arc(5)
    defaults = OdometryConfig()
    arc = {}
    for method in ("icp_plane", "icp_point"):
        cfg = odom_cfg(method=method, scan_capacity=defaults.scan_capacity,
                       map_capacity=defaults.map_capacity,
                       icp=ICPParams(max_iterations=25, max_corr_dist=1.0))
        eng = LidarOdometry(cfg)
        n0 = launches_of(nearest_neighbors)
        poses, _, kept = run_host(eng, clouds, gt[0], keep=(1,))
        arc[method] = dict(ate_m=ate_rmse(poses, gt, align=False),
                           nn_search_launches=launches_of(nearest_neighbors)
                           - n0)
        if method == "icp_plane":
            st = kept[1]
            scan = eng.downsample(clouds[2])
            init = st.pose @ eng._clamped_delta(st.last_delta)
            normals, n_valid = voxel_normals_neighborhood(st.vmap,
                                                          eng.map_spec)
            tgt = PointCloud(points=voxel_means(st.vmap, eng.map_spec),
                             mask=st.vmap.occupied_mask() & n_valid
                             ).sanitize()
            src = scan.sanitize()
            nn_args = (se3.apply(init, src.points).contiguous(),
                       tgt.points.contiguous(), src.mask, tgt.mask)
    out["office_arc"] = arc

    out["room_eviction"] = room_eviction_case()

    # JitLidarOdometry on the office arc, then on config 2's route
    clouds, gt = office_arc(8)
    jit = JitLidarOdometry(odom_cfg())
    s = jit.init_state(clouds[0], gt[0])
    jposes = [s.pose]
    for c in clouds[1:]:
        s = jit.step(s, c)
        jposes.append(s.pose)
    jm = s.last_metrics.cpu().numpy()
    out["jit_arc"] = dict(
        ate_m=ate_rmse(torch.stack(jposes).cpu().numpy(), gt, align=False),
        matched=float(jm[1]), accepted=float(jm[2]),
        scan_index=int(s.scan_index))
    jit = JitLidarOdometry(config2())
    torch.cuda.synchronize()
    ts = time.perf_counter()
    s = jit.init_state(c2_clouds[0], c2_gt[0])
    jposes = [s.pose]
    for c in c2_clouds[1:]:
        s = jit.step(s, c)
        jposes.append(s.pose)
    jposes = torch.stack(jposes).cpu().numpy()
    dt = time.perf_counter() - ts
    out["jit_config2"] = dict(scans_per_s=len(c2_clouds) / dt,
                              ate_m=ate_rmse(jposes, c2_gt, align=False))

    launches = dict(ndt_terms=launches_of(ndt_terms),
                    nn_search=launches_of(nearest_neighbors))
    emit("host_engine_cases", seconds=time.perf_counter() - t0,
         launches=launches, **out)
    pyr = out["pyramid_worst_m"]
    ref_pyr = REF_KERNEL_PATH["pyramid_worst_m"]
    checks = [
        (abs(ring["auto"]["worst_m"] - REF_KERNEL_PATH["ring_worst_m"])
         <= KERNEL_PATH_TOL_M, "ring worst (auto) as the reference's"),
        (ring["xla"]["worst_m"] < RING_WORST_BAR_M, "ring worst (xla)"),
        (pyr["xla"][4] < 0.5 * pyr["xla"][0], "pyramid capture (xla)"),
        (all(abs(pyr["auto"][pf] - ref_pyr[pf]) <= KERNEL_PATH_TOL_M
             for pf in (0, 4)), "pyramid (auto) as the reference's"),
        (out["hall"]["ate_m"] < HALL_ATE_BAR_M, "hall ATE"),
        (out["hall"]["fixed_grid_ate_m"] > 5.0 * out["hall"]["ate_m"],
         "hall fixed-grid control"),
        (out["hall"]["offset0_x_err"] < hall_cfg.map_leaf, "hall offset"),
        (arc["icp_plane"]["ate_m"] < ARC_ICP_ATE_BAR_M, "icp_plane ATE"),
        (abs(arc["icp_point"]["ate_m"] - REF_ICP_POINT_ATE_M)
         <= ICP_POINT_TOL_M, "icp_point ATE as the reference's"),
        (out["room_eviction"]["box_voxels_before"] > 10, "box in the map"),
        (out["room_eviction"]["box_voxels_after"]
         < 0.2 * out["room_eviction"]["box_voxels_before"], "box evicted"),
        (out["room_eviction"]["voxels_after"]
         > 0.6 * out["room_eviction"]["voxels_before"], "room kept"),
        (out["room_eviction"]["min_matched"] > 0.5, "room registration"),
        (out["jit_arc"]["ate_m"] < ARC_JIT_ATE_BAR_M, "jit ATE"),
        (out["jit_arc"]["matched"] > 0.5 and out["jit_arc"]["accepted"] == 1
         and out["jit_arc"]["scan_index"] == 8, "jit metrics"),
        (launches["ndt_terms"] > 0 and launches["nn_search"] > 0,
         "kernel launches"),
        ((ndt_terms_plain.launches, nearest_neighbors_plain.launches)
         == plain_before, "no plain kernel version"),
    ]
    failed = [name for ok, name in checks if not ok]
    if failed:
        raise AssertionError(f"host_engine_cases failed: {failed}")
    return launches, cube_args, nn_args


def slam_host_cfg():
    """tests/test_pipeline.py _slam_cfg on the default (host) engine."""
    from tpu_slam_torch.graph.loop_closure import LoopClosureParams
    from tpu_slam_torch.graph.pose_graph import GraphSolveParams
    from tpu_slam_torch.pipeline.config import SLAMConfig
    from tpu_slam_torch.registration.icp import ICPParams

    return SLAMConfig(
        odometry=odom_cfg(), keyframe_translation=0.4,
        keyframe_rotation=0.25, keyframe_capacity=64,
        keyframe_cloud_capacity=2048, loop_every=4,
        loop=LoopClosureParams(
            max_distance=1.5, min_index_gap=8, max_candidates=4,
            min_matched_fraction=0.5, max_error=0.05,
            icp=ICPParams(max_iterations=25, max_corr_dist=1.0,
                          huber_delta=0.3)),
        graph=GraphSolveParams(gn_iterations=6, robust_delta=2.0,
                               robust_kernel="cauchy"),
        edge_capacity=256)


def phase_slam_host(tmpdir):
    """SLAMSystem on the host engine over test_slam_full_loop's workload
    (40 scans round the office, 240 azimuths); a checkpoint after scan 20
    resumed in a fresh system must end on the same poses bit for bit."""
    import os

    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.pipeline.checkpoint import (load_checkpoint,
                                                    save_checkpoint)
    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    clouds, gt = office_arc(40, n_azimuth=240, arc_fraction=1.0)
    cfg = slam_host_cfg()
    plain_before = (ndt_terms_plain.launches,
                    nearest_neighbors_plain.launches)
    reset_launches(ndt_terms, nearest_neighbors)
    slam = SLAMSystem(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = slam.init_state(gt[0])
    poses, snap = [], None
    for k, c in enumerate(clouds):
        state, _ = slam.step(state, c)
        poses.append(state.odom.pose.cpu().numpy())
        if k + 1 == SLAM_HOST_RESUME_AT:
            snap = state
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(ndt_terms=launches_of(ndt_terms),
                    nn_search=launches_of(nearest_neighbors))
    poses = np.stack(poses)
    ate = ate_rmse(poses, gt, align=False)

    path = save_checkpoint(os.path.join(tmpdir, "slam_host"), snap,
                           scan_index=SLAM_HOST_RESUME_AT)
    resumed, manifest = load_checkpoint(path)
    fresh = SLAMSystem(cfg)
    tail = []
    for c in clouds[SLAM_HOST_RESUME_AT:]:
        resumed, _ = fresh.step(resumed, c)
        tail.append(resumed.odom.pose.cpu().numpy())
    same = bool(np.array_equal(np.stack(tail), poses[SLAM_HOST_RESUME_AT:]))
    emit("slam_host", scans=len(clouds), seconds=dt,
         scans_per_s=len(clouds) / dt, ate_m=ate,
         keyframes=state.n_keyframes, loops=state.n_loop_closures,
         stage_seconds=dict(slam.stage_seconds), launches=launches,
         resumed_after_scan=SLAM_HOST_RESUME_AT, manifest=manifest,
         resume_bit_identical=same)
    if (ndt_terms_plain.launches, nearest_neighbors_plain.launches) \
            != plain_before or min(launches.values()) <= 0:
        raise AssertionError("slam_host launched no kernel or ran a plain "
                             "version")
    if not (state.n_keyframes >= SLAM_HOST_MIN_KF
            and state.n_loop_closures > 0 and ate < SLAM_HOST_ATE_BAR_M):
        raise AssertionError(f"slam_host: {state.n_keyframes} keyframes, "
                             f"{state.n_loop_closures} loops, ATE {ate} m")
    if not same:
        raise AssertionError("slam_host resume differs")
    return launches


def phase_host_kernels(fine_args, cube_args, nn_args):
    """ndt_terms at host_odometry's (192, 192, 32) fine window and at the
    outdoor ring's 64^3 cube, nn_search at icp_plane's 32,768 x 131,072
    first iteration, each against its plain version."""
    terms = [check_terms_case("host_fine_192x192x32", fine_args),
             check_terms_case("host_cube_64", cube_args)]
    nn = [check_nn_case("icp_plane_32k_x_131k", *nn_args)]
    emit("kernels", kernels=["ndt_terms", "nn_search"], cases=terms + nn,
         rtol_of_max=RTOL_OF_MAX)
    return terms, nn


# ---------------------------------------------------------------------------
# The rotating-scanner live chain: an LMS100 on the rotating unit streaming
# CoLa-A telegrams -> NativeLms -> NativeFeeder -> FrameChain ->
# ScanAggregator -> SLAMSystem (tpu_slam_torch/pipeline/live.py)
# ---------------------------------------------------------------------------

LMS_HZ = 50.0                   # LMS100's line rate
LMS_BEAMS = 541                 # 270 degrees at 0.5 degree a beam
LMS_STEP_DEG = 0.5
# the survey's startAngle (LiveConfig.start_angle_deg): beam i at -135 +
# 0.5 i degrees in the laser frame, so the fan's middle beam runs along
# the unit's rotation axis (the laser's x) and a 1.1 pi turn sees the whole
# sphere; the default -45 centres the fan across the axis, and a 1.1 pi
# turn then sees 1.1 pi of azimuth (the reference's own loopback test,
# tests/test_native.py:453, also runs the LMS100 at -135)
LIVE_START_DEG = -135.0
# the survey: the base stops at the 32 poses of a closed 2.5 m circle in the
# office (0.49 m and 11.25 degrees apart) while the unit turns on without a
# break; an encoder step a line of 1.1 pi / 148.5 makes each 3D scan 150
# lines (the first latches, 149 steps pass the 1.1 pi trigger, 148 fall
# 0.0116 rad short of it: far outside the float32 sums' error). At 16
# stops (0.98 m, 22.5 degrees) the host engine's NDT cannot register the
# first step from its zero-velocity prediction, nor later ones from the
# constant-velocity prediction clamped to 0.7 m / 0.3 rad: the reference
# loses that route at its first registration (ATE 5.33 m on a CPU)
SURVEY_STOPS = 32
SURVEY_RADIUS = 2.5
SURVEY_STEP = 1.1 * math.pi / 148.5
SURVEY_RERUN = 4                # captures of the unpaced rerun
SURVEY_EAGER = 2                # captures of compiled_slam's eager rerun
# loop.min_index_gap of the survey's SLAMConfig: a keyframe comes every
# second stop (0.98 m), ~16 in all, and the default gap of 20 keyframes
# never passes; 12 lets the closing pair (keyframes 0 and 14, 1.91 m
# apart) be verified at the 15-keyframe sweep
SURVEY_LOOP_GAP = 12
# tpu_slam's ScanAggregator + SLAMSystem on the same lines on a CPU
# (python -m tests.test_torch_live_reference: 17 keyframes, 2 loops), and
# the bar around it
LIVE_REF = dict(ate_m=0.011763400779688628)
LIVE_TOL_M = 0.02
# the calibration capture: 2 pi at 0.5 degree a line in the reference
# test's room (tests/test_calibration.py:40-43) with its TRUE_PARAMS
CALIB_SEGMENTS = 720
CALIB_TRUE = (0.02, -0.015, 0.012, -0.018, 0.025)
CALIB_TWIDDLE_BAR = 0.04
CALIB_GRADIENT_BAR = 0.025
CALIB_GRADIENT_STEPS = 200


class Loopback:
    """A device on a loopback TCP port served by a thread of its own
    (``_serve``); ``join`` waits for it and raises what it raised."""

    def __init__(self):
        import socket
        import threading

        self.srv = socket.create_server(("127.0.0.1", 0))
        self.srv.settimeout(120.0)
        self.port = self.srv.getsockname()[1]
        self.error = None
        self.thread = threading.Thread(target=self._serve, daemon=True)

    def join(self, timeout=10.0):
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise RuntimeError(f"{type(self).__name__} did not finish")
        if self.error is not None:
            raise self.error


class FakeLms(Loopback):
    """A CoLa-A scanner on loopback: after ``sEN LMDscandata 1`` it sends
    the given telegrams on a fixed schedule, one every ``period_s``, then
    closes. ``max_late_s`` is the most a telegram left after its due time.
    With ``gate`` it sends telegram k once ``gate(k)`` holds instead: as
    fast as the consumer takes them, without overflowing its ring. A
    client that hangs up early ends the stream (``client_left``)."""

    def __init__(self, telegrams, period_s=1.0 / LMS_HZ, gate=None):
        import threading

        super().__init__()
        self.telegrams = telegrams
        self.period_s = period_s
        self.gate = gate
        self.max_late_s = 0.0
        self.sent = 0
        self.client_left = False
        self._stop = threading.Event()
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.srv.accept()
            with conn:
                if b"sEN LMDscandata 1" not in conn.recv(256):
                    raise ConnectionError("no LMDscandata request")
                t0 = time.perf_counter()
                for k, raw in enumerate(self.telegrams):
                    if self.gate is not None:
                        while not self.gate(k) and not self._stop.is_set():
                            time.sleep(0.0005)
                    elif self.period_s:
                        late = time.perf_counter() - (t0 + k * self.period_s)
                        if late < 0:
                            time.sleep(-late)
                        self.max_late_s = max(self.max_late_s, late)
                    if self._stop.is_set():
                        break
                    conn.sendall(raw)
                    self.sent += 1
                time.sleep(0.3)
        except (BrokenPipeError, ConnectionResetError):
            self.client_left = True
        except OSError as e:
            self.error = e
        finally:
            self.srv.close()

    def stop(self):
        """End the stream early (a gate that will never open)."""
        self._stop.set()


class FakeM3d(Loopback):
    """The rotating unit's motor controller on loopback, speaking the sp/gp
    parameter protocol (driverLib.cpp): records every write; the k-th read
    of the position register (0x396A) returns ``ticks(k)``."""

    def __init__(self, ticks, enc_res_hw=2500):
        super().__init__()
        self.ticks = ticks
        self.reads = 0
        self.params = {(0x3962, 0x0): enc_res_hw}
        self.writes = []
        self.thread.start()

    def _serve(self):
        try:
            conn, _ = self.srv.accept()
            with conn:
                buf = b""
                while True:
                    data = conn.recv(256)
                    if not data:
                        break
                    buf += data
                    while b"\n" in buf:
                        line, buf = buf.split(b"\n", 1)
                        self._handle(conn, line.decode().split())
        except OSError as e:
            self.error = e
        finally:
            self.srv.close()

    def _handle(self, conn, parts):
        if len(parts) < 2:
            return
        idx, sub = parts[1].split(".")
        addr = (int(idx.rstrip("h"), 16), int(sub.rstrip("h"), 16))
        if parts[0] == "sp":
            val = int(parts[2])
            self.params[addr] = val
            self.writes.append((addr[0], addr[1], val))
            conn.sendall(f"sp {parts[1]} {val}\n".encode())
        elif parts[0] == "gp":
            if addr == (0x396A, 0x0):
                val = int(self.ticks(self.reads))
                self.reads += 1
            else:
                val = self.params.get(addr, 0)
            # four fields, the value third (driverLib.cpp:145)
            conn.sendall(f"gp {parts[1]} {val} ok".encode())


def lms_telegram(ranges_m, k, start_deg=LIVE_START_DEG):
    """LMS100's telegram of one line: ranges in mm on the wire."""
    from tpu_slam_torch.ingest.sick_cola import format_telegram

    mm = np.round(np.asarray(ranges_m, np.float64) * 1000).astype(np.uint32)
    return format_telegram(mm, scan_no=k, start_angle_deg=start_deg,
                           ang_step_deg=LMS_STEP_DEG,
                           scan_frequency_hz=LMS_HZ)


def render_lines(world, T_world_base, T_base_laser, beams=LMS_BEAMS,
                 start_deg=LIVE_START_DEG):
    """Ranges (m, 0 = no return) of lines seen from the laser poses
    T_world_base[k] @ T_base_laser[k], beam i at start_deg + 0.5 i degrees
    in the laser frame (the simulator's scanner is symmetric about its x,
    so its frame is the laser's turned by start_deg + 135 degrees)."""
    from tpu_slam_torch.ingest.synthetic import simulate_line_scan

    fov = LMS_STEP_DEG * (beams - 1)
    turn = math.radians(start_deg + fov / 2)
    c, s = math.cos(turn), math.sin(turn)
    rz = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    out = np.zeros((len(T_base_laser), beams))
    for k, (Tw, Tl) in enumerate(zip(T_world_base, T_base_laser)):
        pts, valid = simulate_line_scan(
            world, Tw @ np.asarray(Tl, np.float64) @ rz, n_beams=beams,
            fov_deg=fov)
        out[k] = np.linalg.norm(pts.astype(np.float64), axis=1) * valid
    return out


def survey(n_stops=SURVEY_STOPS, beams=LMS_BEAMS):
    """The stop-and-go survey's line stream.

    The encoder angle of line k is k * SURVEY_STEP. Which stop a line
    belongs to is decided by the aggregator's own trigger: a CPU
    ScanAggregator runs over the lines' transforms, and the base moves to
    the next stop at the line after each emit. Returns (telegrams,
    encoder angles, the stop of each line, the route (n_stops, 4, 4)).
    """
    import torch

    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.ingest.aggregator import (AggregatorConfig,
                                                  ScanAggregator)
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    agg = ScanAggregator(AggregatorConfig(capacity=1, line_length=1),
                         device="cpu")
    zero_p = torch.zeros((1, 3))
    zero_v = torch.zeros(1, dtype=torch.bool)
    state = agg.init_state()
    angles, stops, T_bl = [], [], []
    stop = 0
    while stop < n_stops:
        a = len(angles) * SURVEY_STEP
        T = chain.base_from_laser(a)
        angles.append(a)
        stops.append(stop)
        T_bl.append(T.numpy())
        state = agg.add_line(state, zero_p, zero_v, T)
        if bool(agg.ready(state)):
            _, state = agg.emit(state)
            stop += 1
    route = syn.trajectory_loop(n_stops, radius=SURVEY_RADIUS)
    ranges = render_lines(syn.default_office(), route[stops], T_bl, beams)
    telegrams = [lms_telegram(r, k) for k, r in enumerate(ranges)]
    return telegrams, np.asarray(angles), np.asarray(stops), route


def survey_slam_config():
    """SLAMConfig() on the host engine, the loop gap cut to the survey."""
    from tpu_slam_torch.graph.loop_closure import LoopClosureParams
    from tpu_slam_torch.pipeline.config import SLAMConfig

    return SLAMConfig(loop=LoopClosureParams(min_index_gap=SURVEY_LOOP_GAP))


def counter_source(angles):
    """The angle source of a replayed stream: the k-th call returns the
    k-th line's angle (the producer calls it once a line)."""
    k = [0]

    def source():
        a = angles[min(k[0], len(angles) - 1)]
        k[0] += 1
        return float(a)

    return source


def relative_route(route, n):
    """Ground truth of the SLAM poses, which start at the identity: the
    route's first n poses relative to its first."""
    return np.linalg.inv(route[0]) @ route[:n]


def survey_pipeline():
    """A LivePipeline of the survey on the card: LiveConfig() at the
    survey's startAngle, AggregatorConfig(), SLAMSystem on the host
    engine."""
    from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    return LivePipeline(LiveConfig(start_angle_deg=LIVE_START_DEG),
                        slam=SLAMSystem(survey_slam_config()))


def stream(pipe, telegrams, angles, period_s=1.0 / LMS_HZ, gated=False,
           **kw):
    """Drive ``pipe`` from a fake LMS100 sending ``telegrams``: every
    period_s, or (gated) as fast as the chain takes them, never more than
    64 lines ahead of the consumer. Returns (results, clouds, poses,
    seconds, the fake's largest lateness)."""
    from tpu_slam_torch.ingest.native import NativeLms

    gate = (lambda k: k < pipe.lines + 64) if gated else None
    dev = FakeLms(telegrams, period_s=period_s, gate=gate)
    lms = NativeLms(cap=pipe.config.line_capacity)
    clouds, poses = [], []

    def on_scan(cloud, metrics):
        clouds.append(cloud)
        if pipe.slam is not None:
            poses.append(pipe.slam_state.odom.pose)

    t0 = time.perf_counter()
    try:
        lms.connect("127.0.0.1", dev.port)
        lms.start_scan()
        results = pipe.run(lms, angle_source=counter_source(angles),
                           on_scan=on_scan, **kw)
    finally:
        dt = time.perf_counter() - t0
        lms.close()
        dev.stop()
        dev.join()
    return results, clouds, poses, dt, dev.max_late_s


def live_line_profile(telegrams, angles):
    """The consumer's cost a line: one capture streamed (gated) through
    the chain with no SLAM, under torch.profiler: kernel and graph
    launches, H2D copies, device-to-host reads, device busy time and the
    host clock a line. The first run's lines are checked for reads or
    syncs inside a captured call (``replays_checked`` counts them), and
    its clouds are returned beside the costs."""
    import torch

    from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline

    pipe = LivePipeline(LiveConfig(start_angle_deg=LIVE_START_DEG))
    n = len(telegrams)

    def run():
        out = stream(pipe, telegrams, angles, gated=True, max_lines=n)
        torch.cuda.synchronize()
        return out[1]

    with replays_sync_checked() as chk:
        clouds = run()
    t0 = time.perf_counter()
    run()
    wall = time.perf_counter() - t0
    per_kernel, prof = device_time_us(run, 1)
    ka = prof.key_averages()

    def count(pred):
        return sum(e.count for e in ka if pred(e.key))

    return clouds, dict(
        lines=pipe.lines, replays_checked=chk.calls,
        line_graphs=len(pipe.aggregator._lines),
        host_ms_per_line=wall * 1e3 / n,
        device_busy_us_per_line=sum(per_kernel.values()) / n,
        kernel_launches_per_line=count(
            lambda k: k in ("cudaLaunchKernel", "cuLaunchKernel",
                            "cuLaunchKernelEx")) / n,
        graph_launches_per_line=count(lambda k: k in GRAPH_LAUNCHES) / n,
        h2d_copies_per_line=count(lambda k: "Memcpy HtoD" in k) / n,
        dtoh_reads_per_line=count(lambda k: "Memcpy DtoH" in k) / n,
        scalar_reads_per_line=count(
            lambda k: k == "aten::_local_scalar_dense") / n,
        top_ops_per_line=[(e.key[:60], e.count / n) for e in sorted(
            (e for e in ka if e.key.startswith("aten::")),
            key=lambda e: -e.count)[:12]])


def phase_live():
    """The rotating unit's live chain on the card: the survey streamed at
    LMS100's 50 Hz through LivePipeline -> SLAMSystem, then its first
    captures again unpaced (bit-identical), the cost a line and a scan,
    and the kernel cases of the path. Returns ({kernel: launches}, the
    ndt_terms args and the nn_search args of the path, and the survey's
    run for phase_compiled_slam)."""
    import torch

    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.pipeline.metrics import ate_rmse

    t0 = time.perf_counter()
    telegrams, angles, stops, route = survey()
    gen_s = time.perf_counter() - t0
    pipe = survey_pipeline()
    plain_before = (ndt_terms_plain.launches,
                    nearest_neighbors_plain.launches)
    reset_launches(ndt_terms, nearest_neighbors)
    results, clouds, poses, dt, late = stream(pipe, telegrams, angles,
                                              max_scans=SURVEY_STOPS)
    launches = dict(ndt_terms=launches_of(ndt_terms),
                    nn_search=launches_of(nearest_neighbors))
    state = pipe.slam_state
    poses = torch.stack(poses).cpu().numpy()
    n = len(results)
    gt = relative_route(route, n)
    ate = ate_rmse(poses, gt, align=False)
    step_ms = np.array([m.wall_time_s * 1e3 for _, m in results])
    points = [int(c.mask.sum()) for c in clouds]

    # the first captures again, as fast as the chain takes them
    k = int(np.searchsorted(stops, SURVEY_RERUN))
    again = survey_pipeline()
    r2, c2, p2, dt2, _ = stream(again, telegrams[:k], angles[:k],
                                gated=True, max_scans=SURVEY_RERUN)
    same = (len(c2) == SURVEY_RERUN and all(
        torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)
        for a, b in zip(c2, clouds)) and all(
        torch.equal(a, b) for a, b in zip(
            p2, [torch.as_tensor(p, device="cuda") for p in poses])))

    # the cost a line (no SLAM) and of a SLAM step (scans 2 and 3 replayed
    # from the state after scan 1)
    first = int(np.searchsorted(stops, 1))
    line_clouds, per_line = live_line_profile(telegrams[:first],
                                              angles[:first])
    slam = again.slam
    s = slam.init_state()
    s, _ = slam.step(s, clouds[0])
    s, _ = slam.step(s, clouds[1])
    per_step = host_step_profile(slam, s, clouds[2:4])
    lines_per_scan = first
    busy_ms = (lines_per_scan * per_line["device_busy_us_per_line"] / 1e3
               + per_step["device_busy_ms_per_step"])
    unpaced_ms = (lines_per_scan * per_line["host_ms_per_line"]
                  + per_step["wall_ms_per_step"])
    per_scan = {key: lines_per_scan * per_line[f"{key}_per_line"]
                + per_step[f"{key}_per_step"]
                for key in ("kernel_launches", "h2d_copies", "dtoh_reads",
                            "scalar_reads")}
    emit("live", lines=len(telegrams), stops=SURVEY_STOPS,
         beams=LMS_BEAMS, line_hz=LMS_HZ, generate_seconds=gen_s,
         scans=n, points_per_scan=points,
         mean_points=float(np.mean(points)),
         feeder_dropped=pipe.dropped_lines, lines_consumed=pipe.lines,
         seconds=dt, lines_per_s=pipe.lines / dt,
         fake_lms_max_late_ms=late * 1e3,
         slam_step_ms_p50=float(np.percentile(step_ms, 50)),
         slam_step_ms_p95=float(np.percentile(step_ms, 95)),
         slam_step_ms=[round(x, 1) for x in step_ms],
         keyframes=state.n_keyframes, loops=state.n_loop_closures,
         ate_m=ate, reference_ate_m=LIVE_REF["ate_m"],
         matched=[round(m.matched_fraction, 4) for _, m in results],
         launches=launches,
         ndt_terms_launches_per_scan=launches["ndt_terms"] / n,
         rerun_scans=len(c2), rerun_lines=again.lines,
         rerun_dropped=again.dropped_lines,
         rerun_bit_identical=bool(same),
         unpaced_lines_per_s=again.lines / dt2, per_line=per_line,
         per_step=per_step, per_scan=per_scan,
         device_busy_ms_per_scan=busy_ms,
         device_idle_share_paced=1.0 - busy_ms / (
             lines_per_scan / LMS_HZ * 1e3),
         device_idle_share_unpaced=1.0 - busy_ms / unpaced_ms)
    if (ndt_terms_plain.launches, nearest_neighbors_plain.launches) \
            != plain_before or min(launches.values()) <= 0:
        raise AssertionError("the live path launched no ndt_terms or "
                             f"nn_search kernel ({launches}), or ran a "
                             "plain version")
    if pipe.dropped_lines != 0 or again.dropped_lines != 0:
        raise AssertionError(f"feeder dropped {pipe.dropped_lines} lines "
                             f"at 50 Hz ({again.dropped_lines} unpaced)")
    if n != SURVEY_STOPS or pipe.lines != len(telegrams):
        raise AssertionError(f"live: {n} scans of {pipe.lines} lines")
    if not np.all(np.isfinite(poses)) or min(points) <= 0:
        raise AssertionError("live: poses not finite or an empty scan")
    if not abs(ate - LIVE_REF["ate_m"]) <= LIVE_TOL_M:
        raise AssertionError(f"live ATE {ate} m is not within {LIVE_TOL_M} "
                             f"m of the reference's {LIVE_REF['ate_m']} m")
    if not same:
        raise AssertionError("the unpaced rerun differs from the paced run")
    cfg = survey_slam_config()
    pairs = sorted(state.loop_pairs) or [(0, state.n_keyframes - 1)]
    terms_args = host_terms_args(slam.odometry, state.odom, clouds[-1])
    nn_args = verification_batch(state, cfg, pairs=pairs)
    survey_run = dict(telegrams=telegrams, angles=angles, clouds=clouds,
                      poses=poses, first=first, per_line=per_line,
                      line_clouds=line_clouds, stops=stops,
                      per_step=per_step, seconds=dt,
                      keyframes=state.n_keyframes,
                      loops=state.n_loop_closures, ate_m=ate)
    return launches, terms_args, nn_args, survey_run


def phase_live_cli(tmpdir):
    """run_live.main against the fake LMS100 and a fake motor controller
    for 2 scans: its JSON lines, the speed it commanded, and the stop."""
    import io
    import os

    import torch

    from tpu_slam_torch.cli import run_live
    from tpu_slam_torch.ingest import synthetic as syn
    from tpu_slam_torch.ingest.frames import (Calibration, FrameChain,
                                              SensorModel)
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    # the unit's encoder: 10,000 ticks a turn, 40 ticks a line (138 lines
    # a 3D scan); run_live's LiveConfig() reads the LMS100 at -45 degrees
    enc_res, per_line, n_lines = 10000, 40, 330
    ticks = np.arange(n_lines) * per_line
    angles = -2.0 * math.pi * (ticks % enc_res) / enc_res
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    T_bl = [chain.base_from_laser(float(a)).numpy() for a in angles]
    start = syn.trajectory_loop(SURVEY_STOPS, radius=SURVEY_RADIUS)[0]
    ranges = render_lines(syn.default_office(), [start] * n_lines, T_bl,
                          start_deg=-45.0)
    telegrams = [lms_telegram(r, k, start_deg=-45.0)
                 for k, r in enumerate(ranges)]
    calib = Calibration().save(os.path.join(tmpdir, "m3d_calibration.yaml"))
    lms = FakeLms(telegrams)
    m3d = FakeM3d(ticks=lambda k: ticks[min(k, n_lines - 1)],
                  enc_res_hw=enc_res // 4)
    reset_launches(ndt_terms, nearest_neighbors)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            run_live.main(["--lms-host", "127.0.0.1", "--lms-port",
                           str(lms.port), "--m3d-host", "127.0.0.1",
                           "--m3d-port", str(m3d.port), "--speed", "12",
                           "--scans", "2", "--calibration", calib, "--json"])
    finally:
        dt = time.perf_counter() - t0
        lms.stop()
        lms.join()
        m3d.join()
    torch.cuda.synchronize()
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    for rec in lines:
        print(json.dumps(rec), flush=True)
    launches = dict(ndt_terms=launches_of(ndt_terms),
                    nn_search=launches_of(nearest_neighbors))
    speed = [(0x3003, 0x0, 3), (0x3000, 0x10, 12), (0x3000, 0x1, 0),
             (0x3000, 0x1, 49)]
    stop = [(0x3003, 0x0, 3), (0x3000, 0x10, 0), (0x3000, 0x1, 0),
            (0x3000, 0x1, 49)]
    emit("live_cli", seconds=dt, json_lines=len(lines),
         motor_writes=[[hex(a), hex(b), v] for a, b, v in m3d.writes],
         encoder_reads=m3d.reads, telegrams_sent=lms.sent,
         launches=launches)
    scans = [r for r in lines if "n_points" in r]
    if not (len(scans) == 2 and all(r["n_points"] > 0 for r in scans)
            and lines[-1].get("n_scans") == 2
            and lines[-1].get("dropped_lines") == 0):
        raise AssertionError(f"run_live printed {lines}")
    if m3d.writes[:4] != speed or m3d.writes[-4:] != stop:
        raise AssertionError(f"run_live's motor writes {m3d.writes}")
    return launches


def calibration_capture(device, segments=CALIB_SEGMENTS, beams=LMS_BEAMS):
    """A full rotation in the reference test's room whose true mount
    carries CALIB_TRUE: segments of the LMS100's 270 degrees."""
    from tpu_slam_torch.cli.run_calibration import demo_data

    return demo_data(device, segments, beams,
                     fov_deg=LMS_STEP_DEG * (beams - 1), true=CALIB_TRUE)[0]


def gauge_error(found, true):
    """Extrinsic error modulo the spin-axis gauge (a pre-rotation about the
    laser's x is an encoder-zero shift the cost cannot see), as
    tests/test_calibration.py measures it: min over phi in [-0.1, 0.1] of
    |log((Rx(phi) M_true)^-1 M_found)|."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.ingest.calibration import extrinsic_matrix

    M_f = extrinsic_matrix(torch.as_tensor(found, dtype=torch.float32))
    M_t = extrinsic_matrix(torch.as_tensor(true, dtype=torch.float32))
    phi = torch.linspace(-0.1, 0.1, 401)
    Rx = torch.zeros(401, 4, 4)
    Rx[:, 0, 0] = Rx[:, 3, 3] = 1.0
    Rx[:, 1, 1] = Rx[:, 2, 2] = torch.cos(phi)
    Rx[:, 1, 2], Rx[:, 2, 1] = -torch.sin(phi), torch.sin(phi)
    e = se3.log(se3.inverse(Rx @ M_t) @ M_f)
    return float(torch.linalg.vector_norm(e, dim=1).min())


# ---------------------------------------------------------------------------
# The live SLAM path's compiled programs (the scan line, the map insert,
# the keyframe store, the batched ICP) against their eager forms
# ---------------------------------------------------------------------------

VERIFY_TIMED = 10              # verification batches timed, each form


def run_profile(fn, units):
    """``fn`` timed on the host clock (after one warm run), then under
    torch.profiler: per unit, the wall ms, the device's busy ms and idle
    share, kernel and graph launches, H2D copies, device-to-host reads
    and scalar reads."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    per_kernel, prof = device_time_us(fn, 1)
    ka = prof.key_averages()
    busy = sum(per_kernel.values())

    def count(keys):
        return sum(e.count for e in ka if keys(e.key)) / units

    return dict(
        wall_ms=wall_us / 1e3 / units, device_busy_ms=busy / 1e3 / units,
        device_idle_share=1.0 - busy / wall_us,
        kernel_launches=count(lambda k: k in KERNEL_LAUNCHES),
        graph_launches=count(lambda k: k in GRAPH_LAUNCHES),
        h2d_copies=count(lambda k: "Memcpy HtoD" in k),
        dtoh_reads=count(lambda k: "Memcpy DtoH" in k),
        scalar_reads=count(lambda k: k == "aten::_local_scalar_dense"))


def line_host_us(compiled, n=150, seed=0):
    """The host's us a line spends on the line's device work alone (no
    stream, no parsing): n random lines of LMS_BEAMS beams staged and
    copied (or copied as three tensors), transformed and aggregated, and
    the ready flag read, as LivePipeline's consumer does; p50 over the
    lines of a second pass."""
    import torch

    from tpu_slam_torch.ingest.aggregator import (AggregatorConfig,
                                                  ScanAggregator, stage_line,
                                                  staged_size)
    from tpu_slam_torch.ingest.frames import FrameChain, SensorModel

    rng = np.random.default_rng(seed)
    L, dev = 1024, torch.device("cuda")
    chain = FrameChain(sensor=SensorModel.by_name("LMS100"))
    agg = ScanAggregator(AggregatorConfig(line_length=L), compiled=compiled)
    staging = torch.zeros(staged_size(L), pin_memory=True)
    ang = np.radians(LIVE_START_DEG) + np.radians(LMS_STEP_DEG) * np.arange(
        LMS_BEAMS)
    dirs = np.stack([np.cos(ang), np.sin(ang), np.zeros(LMS_BEAMS)],
                    1).astype(np.float32)
    lines = [rng.uniform(0.5, 8.0, LMS_BEAMS).astype(np.float32)
             for _ in range(n)]
    times = []
    for _ in range(2):
        state, times = agg.init_state(), []
        for k, r in enumerate(lines):
            t0 = time.perf_counter()
            pts, valid = dirs * r[:, None], r <= 7.5
            if compiled:
                stage_line(staging.numpy(), pts, valid, r, k * SURVEY_STEP)
                state = agg.add_staged_line(
                    state, staging.to(dev, non_blocking=True), chain)
            else:
                p = np.zeros((L, 3), np.float32)
                v = np.zeros(L, bool)
                i = np.zeros(L, np.float32)
                p[:LMS_BEAMS], v[:LMS_BEAMS], i[:LMS_BEAMS] = pts, valid, r
                state = agg.add_line(
                    state, torch.from_numpy(p).to(dev),
                    torch.from_numpy(v).to(dev),
                    chain.base_from_laser(k * SURVEY_STEP, device=dev),
                    torch.from_numpy(i).to(dev))
            bool(agg.ready(state))
            times.append((time.perf_counter() - t0) * 1e6)
    return float(np.percentile(times, 50))


def compiled_lines(survey):
    """The survey's first capture (its lines, no SLAM) through
    LivePipeline on compiled=False, against the captured line's run of
    the live phase (its lines checked under sync-debug "error"): the
    cloud bit for bit, unpaced lines/s (1 / the host time a line, the
    stream's own costs included) and the host us of the line's device work
    alone, each form; the captured line's costs (the eager line's are in
    PERF.md and not profiled again)."""
    import torch

    from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline

    n = survey["first"]
    pipe = LivePipeline(LiveConfig(start_angle_deg=LIVE_START_DEG),
                        compiled=False)
    t0 = time.perf_counter()
    _, clouds, _, _, _ = stream(pipe, survey["telegrams"][:n],
                                survey["angles"][:n], gated=True,
                                max_lines=n)
    torch.cuda.synchronize()
    eager = dict(lines=pipe.lines,
                 host_ms_per_line=(time.perf_counter() - t0) * 1e3 / n)
    captured = dict(survey["per_line"])
    out = {}
    for form, row in (("eager", eager), ("captured", captured)):
        row.update(unpaced_lines_per_s=1e3 / row["host_ms_per_line"],
                   line_host_us_p50=line_host_us(form == "captured"))
        out[form] = row
    cap = survey["line_clouds"]
    out["bit_equal"] = (len(clouds) == len(cap) == 1
                        and same_tensors(clouds, cap)
                        and same_tensors(cap, survey["clouds"][:1]))
    return out


def compiled_survey(survey):
    """The survey's first SURVEY_EAGER captures again, unpaced, with the
    chain and SLAMSystem() on compiled=False, against the paced captured
    run of the live phase: clouds and poses bit for bit. (Every scan of
    the survey runs through SLAMSystem() on both forms in compiled_host,
    with the eager step's costs; the loop sweeps' verification, captured
    against eager, is slam_host's, config 4's and the verification
    batch's.)"""
    import torch

    from tpu_slam_torch.pipeline.live import LiveConfig, LivePipeline
    from tpu_slam_torch.pipeline.slam import SLAMSystem

    pipe = LivePipeline(LiveConfig(start_angle_deg=LIVE_START_DEG),
                        slam=SLAMSystem(survey_slam_config(),
                                        compiled=False), compiled=False)
    n = SURVEY_EAGER
    k = int(np.searchsorted(survey["stops"], n))
    _, clouds, poses, dt, _ = stream(pipe, survey["telegrams"][:k],
                                     survey["angles"][:k], gated=True,
                                     max_scans=n)
    poses = torch.stack(poses).cpu().numpy()
    state = pipe.slam_state
    return dict(
        scans=len(clouds), lines=pipe.lines, dropped=pipe.dropped_lines,
        eager_seconds=dt, keyframes=state.n_keyframes,
        loops=state.n_loop_closures,
        clouds_bit_equal=len(clouds) == n and all(
            same_tensors(a, b) for a, b in zip(clouds, survey["clouds"])),
        poses_bit_equal=bool(np.array_equal(poses, survey["poses"][:n])),
        per_step=dict(captured=survey["per_step"]))


def compiled_slam_host():
    """slam_host's office circle (40 scans, SLAMSystem() on the host
    engine) on both forms: poses and the final state bit for bit, every
    captured call under sync-debug "error"; the captured form's costs a
    step over scans 20-23 (one loop sweep among them) replayed from the
    state after scan 20 (the eager form's are in PERF.md and not
    repeated)."""
    import torch

    from tpu_slam_torch.pipeline.metrics import ate_rmse
    from tpu_slam_torch.pipeline.slam import SLAMSystem
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    clouds, gt = office_arc(40, n_azimuth=240, arc_fraction=1.0)
    k = SLAM_HOST_RESUME_AT
    out, poses, states = {}, {}, {}
    for form, compiled in (("eager", False), ("captured", True)):
        slam = SLAMSystem(slam_host_cfg(), compiled=compiled)

        def run(slam=slam):
            state, ps, snap = slam.init_state(gt[0]), [], None
            for i, c in enumerate(clouds):
                state, _ = slam.step(state, c)
                ps.append(state.odom.pose)
                if i + 1 == k:
                    snap = state
            return state, torch.stack(ps).cpu().numpy(), snap

        with replays_sync_checked() as chk:
            state, poses[form], snap = run()
        states[form] = slam_state_to_numpy(state)
        out[form] = dict(
            ate_m=ate_rmse(poses[form], gt, align=False),
            keyframes=state.n_keyframes, loops=state.n_loop_closures,
            replays_checked=chk.calls,
            per_step=host_step_profile(slam, snap, clouds[k:k + 4])
            if compiled else None)
    differ = sorted(key for key in states["eager"] if not np.array_equal(
        np.asarray(states["eager"][key]),
        np.asarray(states["captured"].get(key))))
    out.update(poses_bit_equal=bool(np.array_equal(poses["eager"],
                                                   poses["captured"])),
               state_keys_differing=differ)
    return out


def compiled_verify(state):
    """Config 4's verification batch (its first 6 loop pairs of 4,096
    points, point-to-plane, both directions) on the captured batched ICP,
    on compiled=False, and on compiled=False with the brute-force NN's
    plain version in place of the kernel: results and decisions bit for
    bit; ms, launches and reads a batch; nn_search's device us a call
    inside the replayed graphs."""
    from unittest import mock

    import torch

    from tpu_slam_torch.graph.loop_closure import verify_candidates
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)
    from tpu_slam_torch.registration import icp as icp_mod

    cfg = config4()
    pairs = sorted(state.loop_pairs)[:6]
    ci = np.asarray([p[0] for p in pairs], np.int32)
    cj = np.asarray([p[1] for p in pairs], np.int32)

    def verify(compiled):
        return verify_candidates(
            state.kf_points, state.kf_mask, state.graph.poses, ci, cj,
            cfg.loop, clouds_normals=(state.kf_normals
                                      if cfg.loop.plane_verify else None),
            compiled=compiled)

    plain0 = nearest_neighbors_plain.launches
    with mock.patch.object(icp_mod, "nearest_neighbors",
                           nearest_neighbors_plain):
        plain = verify(False)
    plain_calls = nearest_neighbors_plain.launches - plain0
    out, res = {}, {}
    for form, compiled in (("eager", False), ("captured", True)):
        verify(compiled)
        with replays_sync_checked() as chk:
            res[form] = verify(compiled)
        n0 = launches_of(nearest_neighbors)
        verify(compiled)
        torch.cuda.synchronize()
        calls = launches_of(nearest_neighbors) - n0
        out[form] = dict(
            ms=host_ms(lambda c=compiled: verify(c), VERIFY_TIMED),
            replays_checked=chk.calls, nn_search_calls=calls,
            nn_search_us_per_call=terms_us_in_graph(
                lambda c=compiled: verify(c), "nn_search", calls),
            iterations=res[form][0].iterations.tolist(),
            accepted=int(res[form][1].sum()),
            **run_profile(lambda c=compiled: verify(c), 1))
    out.update(pairs=len(pairs), points=int(state.kf_points.shape[1]),
               bit_equal=same_tensors(res["eager"], res["captured"]),
               plain_nn_bit_equal=same_tensors(plain, res["captured"]),
               plain_nn_calls=plain_calls)
    return out


def compiled_brute(pairs, rates):
    """Config 1's brute tier at 8k-256k on the captured batched ICP and on
    compiled=False: the result bit for bit, recovery errors, iterations,
    registrations/s from the identity (one timed call after a warm one),
    launches and syncs a registration; and where the captured raster tier
    leads the captured brute tier in the pair_icp phase's slope loops."""
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    out = {}
    for label, (src, tgt, xi) in pairs.items():
        res, row = {}, {}
        for form, compiled in (("eager", False), ("captured", True)):
            with replays_sync_checked() as chk:
                res[form] = brute_register(src, tgt, compiled=compiled)
            prof = registration_profile(
                lambda c=compiled: brute_register(src, tgt, compiled=c),
                lambda: launches_of(nearest_neighbors))
            row[form] = dict(
                registrations_per_s=1e6 / prof["wall_us"],
                recovery_err_mm=recovery_err_mm(xi, res[form].T),
                iterations=int(res[form].iterations),
                replays_checked=chk.calls,
                nn_search_calls=prof["counted_launches"],
                kernel_launches=prof["kernel_launches"],
                graph_launches=prof["graph_launches"],
                host_syncs=prof["host_syncs"],
                htod_copies=prof["htod_copies"],
                device_idle_share=prof["device_idle_share"])
        row["bit_equal"] = same_tensors(res["eager"], res["captured"])
        out[label] = row
    faster = [lb for _, lb in C1_SIZES
              if rates[("raster", lb)] > rates[("brute", lb)]]
    return out, faster


def phase_compiled_slam(survey, c4_state, c1_pairs, c1_rates):
    """The live SLAM path's compiled programs against their eager forms
    (compiled=False) in this call: the survey's lines (the scan line), the
    whole survey through SLAMSystem() and slam_host's office circle (the
    map insert, the keyframe store, the verification ICP, with the
    registrations), config 4's verification batch and config 1's brute
    tier at 8k-256k (the batched ICP). Any difference in the bits, a read
    or a synchronisation inside a captured call, or an accuracy row out
    of its limit fails. Returns the launches of each kernel in the
    phase."""
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    kernels = (ndt_terms, nearest_neighbors)
    reset_launches(*kernels)
    t0 = time.perf_counter()
    parts = PartTimer()
    lines = parts("lines", compiled_lines, survey)
    whole = parts("survey", compiled_survey, survey)
    host = parts("slam_host", compiled_slam_host)
    verify = parts("verify", compiled_verify, c4_state)
    brute, faster = parts("brute", compiled_brute, c1_pairs, c1_rates)
    launches = {k.__name__: launches_of(k) for k in kernels}
    emit("compiled_slam", device=nvidia_smi_line(), lines=lines,
         survey=whole, slam_host=host, verify=verify, config1_brute=brute,
         config1_raster_captured_faster_at=faster,
         config1_slope_rates={f"{t}_{lb}": c1_rates[(t, lb)]
                              for t, lb in sorted(c1_rates)},
         launches=launches, seconds=time.perf_counter() - t0,
         part_seconds=parts.seconds)
    failed = []
    if not lines["bit_equal"]:
        failed.append("the captured line's cloud differs")
    if lines["captured"]["replays_checked"] < survey["first"]:
        failed.append("lines were not replayed")
    if not (whole["clouds_bit_equal"] and whole["poses_bit_equal"]
            and whole["dropped"] == 0 and whole["scans"] == SURVEY_EAGER):
        failed.append(f"the eager survey differs: {whole}")
    if not (host["poses_bit_equal"] and not host["state_keys_differing"]):
        failed.append(f"slam_host differs: {host['state_keys_differing']}")
    for form in ("eager", "captured"):
        row = host[form]
        if not (row["ate_m"] < SLAM_HOST_ATE_BAR_M and row["loops"] > 0):
            failed.append(f"slam_host {form} ATE or loops")
    if host["captured"]["replays_checked"] <= 0:
        failed.append("slam_host replayed no graph")
    if not (verify["bit_equal"] and verify["plain_nn_bit_equal"]
            and verify["captured"]["replays_checked"] == 2):
        failed.append("the verification batch differs, or its plain NN")
    for label, row in brute.items():
        bar = C1_BRUTE_BAR_MM if label == "8k" else C1_LARGE_BAR_MM
        if not (row["bit_equal"]
                and row["captured"]["replays_checked"] == 1
                and all(row[f]["recovery_err_mm"] <= bar
                        for f in ("eager", "captured"))):
            failed.append(f"config 1 brute {label}")
    if failed:
        raise AssertionError(f"compiled_slam failed: {failed}")
    return launches


# ---------------------------------------------------------------------------
# The default SLAM's loop sweep and the host engine's options (the
# after-loop rebuilds, sc_distance, coarsen_map, occupancy_maintain,
# deskew_cloud) against their eager forms
# ---------------------------------------------------------------------------

HOST_OPTION_SCANS = 8          # config 2's scans on both forms, options on
HOST_OPTION_PROFILED = (4, 8)  # the scans replayed under the profiler
PROGRAM_TIMED = 10             # calls of a program alone timed, each form


def cache_replays(cache):
    """The replays so far of each CapturedCall of ``cache`` (by key)."""
    return {k: c.graph.replays for k, c in cache.items()}


def cache_use(cache, before):
    """How ``cache`` was used since ``before`` (``cache_replays``): the
    graphs captured meanwhile; for each graph that ran, its replays, its
    capture's seconds, the bytes it holds and its private pool's reserved
    bytes."""
    used = [(c.graph, c.graph.replays - before.get(k, 0))
            for k, c in cache.items() if c.graph.replays > before.get(k, 0)]
    return dict(captured=len(set(cache) - set(before)),
                replays=[n for _, n in used],
                capture_s=[g.capture_s for g, _ in used],
                held_bytes=[g.held_bytes for g, _ in used],
                pool_bytes=[g.pool_bytes for g, _ in used])


def program_pair(eager_fn, captured_fn):
    """One program alone on both forms (``captured_fn`` replays its graph,
    captured before): the results bit for bit (the captured calls under
    sync-debug "error"); each form's p50 ms over PROGRAM_TIMED calls and
    run_profile's costs a call (launches, graph launches, reads, idle
    share)."""
    res, row = {}, {}
    for form, fn in (("eager", eager_fn), ("captured", captured_fn)):
        fn()
        with replays_sync_checked() as chk:
            res[form] = fn()
        row[form] = dict(ms_p50=host_ms(fn, PROGRAM_TIMED),
                         replays_checked=chk.calls, **run_profile(fn, 1))
    row["bit_equal"] = same_tensors(res["eager"], res["captured"])
    return row


def survey_sweeps(survey):
    """The survey's 32 clouds through SLAMSystem() (survey_slam_config:
    SLAMConfig()'s capacities, 512 keyframes x 8,192 points, a 131,072-voxel
    map) on both forms from fresh systems, the captured one warmed up as
    the live chain warms it: poses and the final state bit for bit (and
    the poses against the live run's); for each accepted loop sweep the
    step's ms by stage (candidates, verify, graph, re-anchor), both forms;
    the map rebuild's and sc_distance's graphs captured during the run (0:
    the warm-up captured them) and the replays of each graph used; then,
    on the state after each accepted sweep, the rebuild (program 1) and
    sc_distance (program 3) alone, captured against eager."""
    import torch

    from tpu_slam_torch.graph import scan_context as sc_mod
    from tpu_slam_torch.mapping.voxel_map import insert_cloud
    from tpu_slam_torch.pipeline import slam as slam_mod
    from tpu_slam_torch.pipeline.state import slam_state_to_numpy

    clouds = survey["clouds"]
    caches = dict(map_rebuild=slam_mod._map_rebuilds,
                  sc_distance=sc_mod._distances)
    out, poses, states, swept = {}, {}, {}, []
    for form, compiled in (("eager", False), ("captured", True)):
        slam = slam_mod.SLAMSystem(survey_slam_config(), compiled=compiled)
        t0 = time.perf_counter()
        slam.warm_up(clouds[0])
        warm_s = time.perf_counter() - t0
        before = {k: cache_replays(c) for k, c in caches.items()}
        state, ps, sweeps = slam.init_state(), [], []
        fallbacks = insert_cloud.fallbacks
        with replays_sync_checked() as chk:
            for i, c in enumerate(clouds):
                stages = dict(slam.sweep_seconds)
                state, m = slam.step(state, c)
                ps.append(state.odom.pose)
                if m.n_loop_closures:
                    sweeps.append(dict(
                        scan=i, keyframes=state.n_keyframes,
                        loops=m.n_loop_closures,
                        step_ms=m.wall_time_s * 1e3,
                        stage_ms={k: (v - stages[k]) * 1e3
                                  for k, v in slam.sweep_seconds.items()}))
                    if compiled:
                        swept.append(state)
        poses[form] = torch.stack(ps).cpu().numpy()
        states[form] = slam_state_to_numpy(state)
        out[form] = dict(
            warm_up_s=warm_s, sweeps=sweeps, keyframes=state.n_keyframes,
            loops=state.n_loop_closures, replays_checked=chk.calls,
            insert_fallbacks=insert_cloud.fallbacks - fallbacks,
            stage_seconds=dict(slam.stage_seconds),
            graphs={k: cache_use(c, before[k]) for k, c in caches.items()})
    differ = sorted(key for key in states["eager"] if not np.array_equal(
        np.asarray(states["eager"][key]),
        np.asarray(states["captured"].get(key))))
    n = len(clouds)
    out.update(
        poses_bit_equal=bool(np.array_equal(poses["eager"],
                                            poses["captured"])),
        poses_equal_live=bool(np.array_equal(poses["captured"],
                                             survey["poses"][:n])),
        state_keys_differing=differ)

    cfg = survey_slam_config()
    spec, cap = cfg.odometry.map_spec(), cfg.odometry.map_capacity
    programs = []
    for st in swept:
        k = st.n_keyframes

        def rebuild(compiled, st=st, k=k):
            return slam_mod._rebuild_map_batched(
                st.graph.poses, st.kf_points, st.kf_mask, k, spec=spec,
                capacity=cap, compiled=compiled)

        def score(compiled, st=st, k=k):
            return sc_mod.sc_distances(st.kf_desc[k - 1], st.kf_desc,
                                       compiled=compiled)

        programs.append(dict(
            keyframes=k, points=int(st.kf_mask.sum()),
            map_rebuild=program_pair(lambda: rebuild(False),
                                     lambda: rebuild(True)),
            sc_distance=program_pair(lambda: score(False),
                                     lambda: score(True))))
    out["programs"] = programs
    return out


def host_options_cfg():
    """config2() on the host engine with its three options on: a pyramid
    (factor 2), occupancy (64 steps, 65,536 voxels) and deskew."""
    import dataclasses

    return dataclasses.replace(config2(), pyramid_factor=2,
                               use_occupancy=True, occupancy_steps=64,
                               occupancy_capacity=65536, deskew=True)


def host_options(clouds, gt):
    """LidarOdometry with host_options_cfg() over config 2's first
    HOST_OPTION_SCANS scans (65,536 rays) on both forms from fresh engines
    (the captured one warmed up): poses, metrics, the map and the
    occupancy grid bit for bit; step p50; the captured form's launches,
    graph launches and reads a step, idle share (scans 5-8 replayed under
    the profiler; PERF.md holds the eager form's, not repeated here); the
    graphs of coarsen_map, occupancy_maintain and deskew_cloud (captured
    in the run: 0; their memory); then each of them alone on the state
    after scan 4, captured against eager."""
    import dataclasses

    from tpu_slam_torch.pipeline import odometry as odo_mod

    caches = dict(coarsen_map=odo_mod._coarsens,
                  occupancy_maintain=odo_mod._maintains,
                  deskew_cloud=odo_mod._deskews)
    a, b = HOST_OPTION_PROFILED
    out, keep, engines = {}, {}, {}
    for form, compiled in (("eager", False), ("captured", True)):
        eng = odo_mod.LidarOdometry(host_options_cfg(), compiled=compiled)
        eng.warm_up(clouds[0])
        before = {k: cache_replays(c) for k, c in caches.items()}
        with replays_sync_checked() as chk:
            poses, state, kept = run_host(eng, clouds, gt[0], keep=(a - 1,))
        recs = eng.metrics.records
        wall = np.array([r.wall_time_s for r in recs[1:]]) * 1e3
        keep[form] = (poses, [dataclasses.replace(r, wall_time_s=0.0)
                              for r in recs], state)
        engines[form] = (eng, kept[a - 1])
        out[form] = dict(
            step_ms_p50=float(np.percentile(wall, 50)),
            matched=[r.matched_fraction for r in recs],
            field_builds=eng.field_builds, replays_checked=chk.calls,
            profile=(host_step_profile(eng, kept[a - 1], clouds[a:b])
                     if compiled else None),
            graphs={k: cache_use(c, before[k]) for k, c in caches.items()})
    (pe, me, se), (pc, mc, sc) = keep["eager"], keep["captured"]
    out["bit_equal"] = dict(
        poses=bool(np.array_equal(pe, pc)), metrics=me == mc,
        state=same_tensors((se.pose, se.vmap, se.occ),
                           (sc.pose, sc.vmap, sc.occ)))
    (ee, st), (ec, _) = engines["eager"], engines["captured"]
    scan = ee.downsample(clouds[a])
    out["programs"] = dict(
        coarsen_map=program_pair(lambda: ee._coarsen(st.vmap),
                                 lambda: ec._coarsen(st.vmap)),
        occupancy_maintain=program_pair(
            lambda: ee._maintain_occupancy(st.occ, st.vmap, st.pose, scan),
            lambda: ec._maintain_occupancy(st.occ, st.vmap, st.pose, scan)),
        deskew_cloud=program_pair(
            lambda: ee._deskew(clouds[a], st.last_delta).points,
            lambda: ec._deskew(clouds[a], st.last_delta).points))
    return out


def phase_compiled_host(survey, c2_clouds, c2_gt):
    """The default SLAM's loop sweep and the host engine's option programs
    against their eager forms (compiled=False) in this call: the survey's
    32 clouds through SLAMSystem() (the map rebuild and sc_distance at
    SLAMConfig()'s capacities, the sweep step by stage), the dense SLAM's
    default re-anchor (the windows' rebuild; one graph a window and one
    captured step across the re-anchors), and config 2's first scans on
    the host engine with the pyramid, occupancy and deskew on (coarsen_map,
    occupancy_maintain, deskew_cloud). Any difference in the bits, a read
    or a synchronisation inside a captured call, a program captured more
    than once, or an accuracy row out of its limit fails. Returns the
    launches of each kernel in the phase."""
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms
    from tpu_slam_torch.kernels.nn_search import nearest_neighbors

    kernels = (ndt_terms, nearest_neighbors)
    reset_launches(*kernels)
    t0 = time.perf_counter()
    parts = PartTimer()
    sweeps = parts("survey", survey_sweeps, survey)
    reanchor = parts("dense_reanchor", dense_reanchor_compare)
    options = parts("host_options", host_options, c2_clouds, c2_gt)
    launches = {k.__name__: launches_of(k) for k in kernels}
    emit("compiled_host", device=nvidia_smi_line(), survey=sweeps,
         dense_reanchor=reanchor, host_options=options, launches=launches,
         seconds=time.perf_counter() - t0, part_seconds=parts.seconds)
    failed = []
    if not (sweeps["poses_bit_equal"] and sweeps["poses_equal_live"]
            and not sweeps["state_keys_differing"]):
        failed.append("the survey's SLAM differs between forms or from "
                      "the live run")
    cap = sweeps["captured"]
    if not (cap["loops"] == survey["loops"]
            and cap["keyframes"] == survey["keyframes"]
            and len(cap["sweeps"]) > 0):
        failed.append("the survey's loops or keyframes moved")
    for name, use in cap["graphs"].items():
        if use["captured"] != 0 or len(use["replays"]) != 1:
            failed.append(f"{name}: not one graph warmed up for every "
                          f"sweep ({use})")
    if cap["graphs"]["map_rebuild"]["replays"] != [len(cap["sweeps"])]:
        failed.append("the map rebuild did not replay once a sweep")
    for row in sweeps["programs"]:
        for name in ("map_rebuild", "sc_distance"):
            if not (row[name]["bit_equal"]
                    and row[name]["captured"]["replays_checked"] == 1):
                failed.append(f"{name} at {row['keyframes']} keyframes")
    if not (reanchor["poses_bit_equal"]
            and not reanchor["state_keys_differing"]
            and reanchor["reanchors"] > 0 and reanchor["captured_steps"] == 1
            and reanchor["grid_rebuild"]["replays"]
            == [reanchor["reanchors"]] * 2):
        failed.append(f"dense re-anchor: {reanchor}")
    if not all(options["bit_equal"].values()):
        failed.append(f"host options differ: {options['bit_equal']}")
    for name, use in options["captured"]["graphs"].items():
        if use["captured"] != 0 or len(use["replays"]) != 1:
            failed.append(f"{name}: not one graph warmed up ({use})")
    for name, row in options["programs"].items():
        if not (row["bit_equal"]
                and row["captured"]["replays_checked"] == 1):
            failed.append(f"{name} alone differs or replayed no graph")
    if not all(np.isfinite(options["captured"]["matched"])):
        failed.append("host options: a matched fraction not finite")
    if failed:
        raise AssertionError(f"compiled_host failed: {failed}")
    return launches


CALIB_PROGRAM_VECTORS = 6     # parameter vectors of overlap_cost, both forms
CALIB_PROFILED_STEPS = 10      # steps of a gradient solve profiled, each form


def calibration_programs(data, cfg, true):
    """overlap_cost and a gradient step alone on both forms
    (program_pair: bits, p50 ms, launches, graph launches, H2D copies and
    reads a call), the cost at CALIB_PROGRAM_VECTORS vectors bit for bit,
    one twiddle evaluation (the copy in, the cost, the read of its accept
    test) profiled on each form, a captured gradient solve of
    CALIB_PROFILED_STEPS steps profiled (its reads), two eager gradient
    solves against each other."""
    import torch

    from tpu_slam_torch.ingest import calibration as cal

    zero = np.zeros(5, np.float32)
    rng = np.random.default_rng(0)
    vecs = [true, zero] + [rng.normal(0, 0.02, 5).astype(np.float32)
                           for _ in range(CALIB_PROGRAM_VECTORS - 2)]
    before = cache_replays(cal._costs)
    with replays_sync_checked() as chk:
        got = [cal.overlap_cost(data, v, cfg) for v in vecs]
    want = [cal.overlap_cost(data, v, cfg, compiled=False) for v in vecs]
    costs = dict(vectors=len(vecs), costs=[int(c) for c in got],
                 bit_equal=all(torch.equal(a, b) for a, b in zip(got, want)),
                 replays_checked=chk.calls,
                 use=cache_use(cal._costs, before),
                 alone=program_pair(
                     lambda: cal.overlap_cost(data, zero, cfg,
                                              compiled=False),
                     lambda: cal.overlap_cost(data, zero, cfg)),
                 evaluation={form: run_profile(
                     lambda c=c: int(cal.overlap_cost(data, zero, cfg,
                                                      compiled=c)), 1)
                     for form, c in (("eager", False), ("captured", True))})

    def fresh():
        p = torch.zeros(5, device=data.device)
        return cal.GradientState(p, cal.adam_init(p), torch.zeros(
            CALIB_GRADIENT_STEPS, device=data.device))

    lr = 3e-3
    before = cache_replays(cal._grad_steps)
    held = dict(eager=fresh(), captured=fresh())
    step = cal._captured_gradient_step(held["captured"], data, cfg, lr)

    def eager_step():
        held["eager"] = cal._gradient_step(held["eager"], data, cfg, lr)
        return held["eager"]

    def captured_step():
        held["captured"] = step(held["captured"], data)
        return held["captured"]

    grad = dict(alone=program_pair(eager_step, captured_step),
                use=cache_use(cal._grad_steps, before))
    grad["solve_profile"] = dict(captured=run_profile(
        lambda: cal.calibrate_gradient(data, cfg,
                                       steps=CALIB_PROFILED_STEPS),
        CALIB_PROFILED_STEPS))
    twice = [cal.calibrate_gradient(data, cfg, steps=2, compiled=False)
             for _ in range(2)]
    grad["eager_repeats"] = bool(
        np.array_equal(twice[0].params5, twice[1].params5)
        and twice[0].history == twice[1].history)
    return costs, grad


def calibration_solves(data, cfg, true):
    """Twiddle, annealing and the gradient solver on both forms
    (compiled=False, then the captured default under sync-debug "error"):
    seconds, evaluations and evaluations/s, costs, parameters and gauge
    errors; the captured solve's path against the eager one's (parameters,
    history, evaluations bit for bit)."""
    import torch

    from tpu_slam_torch.ingest.calibration import (calibrate_gradient,
                                                   calibrate_sa,
                                                   calibrate_twiddle)

    out = {}
    for name, solve in (
            ("twiddle", lambda c: calibrate_twiddle(data, cfg, compiled=c)),
            ("sa", lambda c: calibrate_sa(data, cfg, seed=0, compiled=c)),
            ("gradient", lambda c: calibrate_gradient(
                data, cfg, steps=CALIB_GRADIENT_STEPS, compiled=c))):
        row, res = {}, {}
        for form, compiled in (("eager", False), ("captured", True)):
            with replays_sync_checked() as chk:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                r = res[form] = solve(compiled)
                torch.cuda.synchronize()
                sec = time.perf_counter() - t1
            row[form] = dict(seconds=sec, evaluations=r.evaluations,
                             evaluations_per_s=r.evaluations / sec,
                             cost=r.cost, start_cost=r.history[0],
                             params5=[float(v) for v in r.params5],
                             gauge_error=gauge_error(r.params5, true),
                             replays_checked=chk.calls)
        e, c = res["eager"], res["captured"]
        row["bit_equal"] = bool(np.array_equal(e.params5, c.params5)
                                and e.history == c.history
                                and e.evaluations == c.evaluations
                                and e.cost == c.cost)
        out[name] = row
    return out


def raycast_pair(device="cuda"):
    """The synthetic ray caster on one city scan (config 2's first pose,
    65,536 rays against dense_city's 321 patches) on both forms: the
    ranges bit for bit, p50 ms a scan (inputs copied in, ranges read
    back), the replays checked, the graph used (captured by the script's
    city scans, or here when run alone)."""
    from tpu_slam_torch.ingest import synthetic as syn

    world = syn.dense_city(extent=200.0, seed=0)
    T = city_route(N_SCANS)[0]
    d = syn.vlp16_directions(4096) @ T[:3, :3].T
    o = np.broadcast_to(T[:3, 3], d.shape)
    before = cache_replays(syn._raycasts)
    row, res = {}, {}
    for form, compiled in (("eager", False), ("captured", True)):
        def cast(c=compiled):
            return world.raycast(o, d, 75.0, device=device, compiled=c)

        with replays_sync_checked() as chk:
            res[form] = cast()
            row[form] = dict(ms_p50=host_ms(cast, 5),
                             replays_checked=chk.calls)
    row.update(rays=int(d.shape[0]), patches=len(world.patches),
               hits=int(np.isfinite(res["eager"]).sum()),
               bit_equal=bool(np.array_equal(res["eager"],
                                             res["captured"])),
               use=cache_use(syn._raycasts, before))
    return row


def phase_calibration():
    """The extrinsic calibration at full width on the card: 720 segments
    x 541 beams (389,520 raw points), CalibConfig() at its defaults;
    overlap_cost, the gradient step, twiddle, annealing and the gradient
    solver each on both forms (the captured default and compiled=False:
    bit-equal, no read inside a replay, one capture each), the solves to
    the reference tests' bars, the verification; then the synthetic ray
    caster's two forms on a city scan."""
    from tpu_slam_torch.ingest.calibration import (CalibConfig,
                                                   export_verification,
                                                   overlap_cost)

    parts = PartTimer()
    t0 = time.perf_counter()
    data = calibration_capture("cuda")
    capture_s = time.perf_counter() - t0
    cfg = CalibConfig()
    true = np.asarray(CALIB_TRUE, np.float32)
    zero = np.zeros(5, np.float32)
    costs, grad = parts("programs", calibration_programs, data, cfg, true)
    out = parts("solves", calibration_solves, data, cfg, true)
    verify = export_verification(data, out["gradient"]["captured"]["params5"],
                                 cfg)
    verify_true = export_verification(data, true, cfg)
    raycast = parts("raycast", raycast_pair)
    emit("calibration", segments=int(data.points.shape[0]),
         beams=int(data.points.shape[1]),
         raw_points=int(data.valid.numel()),
         valid_points=int(data.valid.sum()), capture_seconds=capture_s,
         overlap_cost=costs, gradient_step=grad,
         cost_at_truth=int(overlap_cost(data, true, cfg)),
         cost_at_zero=int(overlap_cost(data, zero, cfg)),
         solvers=out, verification=verify,
         verification_at_truth=verify_true, raycast=raycast,
         bars=dict(twiddle=CALIB_TWIDDLE_BAR, gradient=CALIB_GRADIENT_BAR),
         part_seconds=parts.seconds)
    failed = []
    if not (costs["bit_equal"] and costs["alone"]["bit_equal"]):
        failed.append("overlap_cost: captured and eager differ")
    if not (grad["alone"]["bit_equal"] and grad["eager_repeats"]):
        failed.append("gradient step: captured and eager differ, or two "
                      "eager solves do")
    # the city scans at the script's start captured the ray caster's graph
    # for this signature already (none of this phase's calls captures it
    # again); a call alone captures it here
    ray = raycast["use"]
    if (costs["use"]["captured"] != 1 or grad["use"]["captured"] != 1
            or ray["captured"] > 1
            or ray["replays"] != [raycast["captured"]["replays_checked"]]):
        failed.append("a calibration or ray-caster program captured other "
                      "than once a signature")
    if grad["solve_profile"]["captured"]["dtoh_reads"] * (
            CALIB_PROFILED_STEPS) > 1:
        failed.append(f"calibrate_gradient read back more than once: "
                      f"{grad['solve_profile']['captured']}")
    for name, row in out.items():
        if not row["bit_equal"]:
            failed.append(f"{name}: the captured solve left the eager "
                          "one's path")
    if not raycast["bit_equal"]:
        failed.append("the captured ray caster differs from the eager one")
    tw, gr, sa = (out[k]["captured"] for k in ("twiddle", "gradient", "sa"))
    if not tw["gauge_error"] < CALIB_TWIDDLE_BAR:
        failed.append(f"twiddle gauge error {tw}")
    if not gr["gauge_error"] < CALIB_GRADIENT_BAR:
        failed.append(f"gradient gauge error {gr}")
    if not sa["cost"] <= sa["start_cost"]:
        failed.append(f"annealing raised the cost {sa}")
    if failed:
        raise AssertionError("; ".join(failed))


def phase_live_kernels(terms_args, nn_args):
    """ndt_terms on the live survey's fine field (its map after the last
    scan, the last scan binned) and nn_search on its verification batch,
    each against its plain version."""
    terms = [check_terms_case("live_survey_fine", terms_args)]
    nn = [check_nn_case("live_survey_verify", *nn_args)]
    emit("kernels", kernels=["ndt_terms", "nn_search"], cases=terms + nn,
         rtol_of_max=RTOL_OF_MAX)
    return terms, nn


# ---------------------------------------------------------------------------
# The distributed layer (tpu_slam_torch/distributed): config 5 and the
# multichip paths, on ranks spawned through distributed.mesh.run_ranks
# ---------------------------------------------------------------------------

DIST_RANKS = 4
DIST_MAP_REGS = 5               # timed registrations a run
DIST_DENSE_STEPS = 6
DIST_DENSE_FIRST = 7            # config 2's scans 7-13: the turn
DIST_ICP_PAIRS = 6
# bars against the single-device result on the same inputs: the
# reference's own test bars (tests/test_distributed.py)
DIST_MAP_POSE_TOL = 1e-4
DIST_MAP_SCORE_TOL = 1e-3
DIST_DENSE_POSE_TOL = 1e-4
DIST_ICP_T_TOL = 1e-5
DIST_PCG_POSE_TOL, DIST_PCG_CHI2_RTOL = 2e-3, 1e-2
DIST_SCHUR_POSE_TOL, DIST_SCHUR_CHI2_RTOL = 1e-4, 1e-4
DIST_HEARTBEAT_TIMEOUT_S = 1.0


def dist_map_params():
    """Config 3's fine solve (phase_config3's fparams) with a two-iteration
    GNC stage on the same window, from the bench's perturbation."""
    from tpu_slam_torch.registration.ndt import NDTParams

    return NDTParams(max_iterations=5, coarse_iterations=2, tolerance=1e-3,
                     min_voxel_count=3.0, rebin_iters=5, window_dims=C3_FINE)


def dist_graph_solves():
    """(name, solver, params, dtype): the edge-sharded PCG (held to the
    single-device PCG), the Schur solve (held to the dense solve), and the
    Schur solve in float64 (held to the dense solve in float64: the two
    are the same exact elimination, so float32's rounding on a 216-pose
    graph is measured apart from the algorithm)."""
    from tpu_slam_torch.graph.pose_graph import GraphSolveParams

    pcg = GraphSolveParams(gn_iterations=6, cg_iterations=200,
                           cg_tolerance=1e-12)
    dense = GraphSolveParams(gn_iterations=6, solver="dense")
    return [("pcg", "pcg", pcg, "float32"),
            ("schur", "schur", dense, "float32"),
            ("schur64", "schur", dense, "float64")]


def dist_config2():
    """Config 2 at pyramid_factor 1 with the window held still (the
    sharded step has no scroll, as in the reference)."""
    import dataclasses

    return dataclasses.replace(config2(), pyramid_factor=1,
                               rebase_fraction=10.0)


def _sync():
    import torch

    torch.cuda.synchronize()


def _graph_numpy(g):
    return dict(poses=g.poses.cpu().numpy(), n_nodes=int(g.n_nodes),
                edge_i=g.edge_i.cpu().numpy(), edge_j=g.edge_j.cpu().numpy(),
                edge_T=g.edge_T.cpu().numpy(),
                edge_info=g.edge_info.cpu().numpy(),
                edge_mask=g.edge_mask.cpu().numpy())


def _graph_torch(g, device, dtype="float32"):
    import torch

    from tpu_slam_torch.graph.pose_graph import PoseGraph

    def t(x, dt):
        return torch.as_tensor(np.array(x), dtype=dt, device=device)

    f = getattr(torch, dtype)
    return PoseGraph(poses=t(g["poses"], f), n_nodes=int(g["n_nodes"]),
                     edge_i=t(g["edge_i"], torch.long),
                     edge_j=t(g["edge_j"], torch.long),
                     edge_T=t(g["edge_T"], f), edge_info=t(g["edge_info"], f),
                     edge_mask=t(g["edge_mask"], torch.bool))


def _cloud(pts_mask, device):
    import torch

    from tpu_slam_torch.core.pointcloud import PointCloud

    pts, mask = pts_mask
    return PointCloud(points=torch.as_tensor(pts, device=device),
                      mask=torch.as_tensor(mask, device=device))


def _rank_profile(mesh, fn, counter):
    """registration_profile on rank 0; the other ranks make the same three
    calls (the collectives need every rank)."""
    if mesh.rank == 0:
        return registration_profile(fn, counter)
    for _ in range(3):
        fn()
    _sync()
    return None


def dist_map_rank(mesh, job):
    """Config 5 on a rank: its slab of config 3's map (from the stacked
    arrays on disk), the street scan inserted through insert_cloud_sharded,
    then ndt_register_sharded on the kernel tier: the counted main-path
    registration, DIST_MAP_REGS timed ones, a profiled one, and rank 0's
    terms inputs at the result for the kernel check."""
    import torch

    from tpu_slam_torch.distributed import map_shard as ms
    from tpu_slam_torch.kernels.ndt_terms import (build_terms_raster,
                                                  ndt_terms, ndt_terms_plain)

    dev = mesh.device
    stacked = {f: np.load(f"{job['dir']}/{mesh.size}/{f}.npy",
                          mmap_mode="r")
               for f in ms.MAP_FIELDS}
    smap = ms.from_stacked(mesh, stacked)
    spec, params = job["spec"], job["params"]
    smap = ms.insert_cloud_sharded(mesh, smap, _cloud(job["world"], dev),
                                   spec, job["stamp"])
    occ = smap.shard.occupied_mask()
    out = dict(keys=smap.shard.keys[occ].cpu().numpy(),
               count=smap.shard.count[occ].cpu().numpy())
    src = _cloud(job["src"], dev)
    init = torch.as_tensor(job["init"], device=dev)
    center = torch.as_tensor(job["center"], device=dev)

    def register():
        return ms.ndt_register_sharded(mesh, src, smap, spec, init_T=init,
                                       params=params, center=center)

    plain_before = ndt_terms_plain.launches
    _sync()
    mesh.stats.reset()
    ndt_terms.launches = 0
    t0 = time.perf_counter()
    res = register()
    _sync()
    out.update(seconds=time.perf_counter() - t0,
               launches=ndt_terms.launches,
               plain_launches=ndt_terms_plain.launches - plain_before,
               collectives=mesh.stats.as_dict(),
               T=res.T.cpu().numpy(), score=float(res.score),
               matched=float(res.matched_fraction),
               iterations=int(res.iterations))
    _sync()
    t0 = time.perf_counter()
    for _ in range(job["regs"]):
        register()
    _sync()
    out["regs_per_s"] = job["regs"] / (time.perf_counter() - t0)
    out["profile"] = _rank_profile(mesh, register,
                                   lambda: ndt_terms.launches)
    # rank 0's share of the terms pass at the result, for the kernel check
    wx, wy, wz = params.window_dims
    rows, c0 = ms.window_rows_local(mesh, smap.shard, spec, params,
                                    params.window_dims, center)
    if mesh.rank == 0:
        s = wx // mesh.size
        sane = src.sanitize()
        origin_w = spec.origin_tensor(dev) + c0.to(torch.float32) * spec.leaf
        slots, _ = build_terms_raster(sane.points, sane.mask, res.T,
                                      origin_w, spec.leaf, (wx, wy, wz),
                                      params.raster_q, own_x=(0, s))
        out["case"] = dict(points=slots.points.cpu().numpy(),
                           cell=slots.cell.cpu().numpy(),
                           valid=slots.valid.cpu().numpy(),
                           rows=rows.cpu().numpy(), T=res.T.cpu().numpy(),
                           gamma=float(np.float32(params.score_temperature)),
                           max_corr=params.max_corr_dist,
                           dims=(s + 2, wy, wz))
    return out


def dist_dense_rank(mesh, job):
    """dense_step_sharded over config 2's scans through the turn from this
    rank's x-chunk of the engine's first window."""
    from tpu_slam_torch.distributed.dense_shard import dense_step_sharded
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms, ndt_terms_plain

    dims = job["dims"]
    rows, oc, pose, delta, scans = _dense_rank_inputs(mesh, job)
    poses, metrics, step_s = [], [], []
    plain_before = ndt_terms_plain.launches
    _sync()
    mesh.stats.reset()
    ndt_terms.launches = 0
    for scan in scans:
        t0 = time.perf_counter()
        rows, pose, delta, m = dense_step_sharded(
            mesh, rows, oc, pose, delta, scan, job["spec"], dims,
            job["params"], **job["gates"])
        poses.append(pose.cpu().numpy())
        metrics.append(m.cpu().numpy())
        step_s.append(time.perf_counter() - t0)
    return dict(poses=np.stack(poses), metrics=np.stack(metrics),
                step_s=step_s, launches=ndt_terms.launches,
                plain_launches=ndt_terms_plain.launches - plain_before,
                collectives=mesh.stats.as_dict())


def dist_icp_rank(mesh, job):
    """sharded_pairwise_icp on the slam run's verification batch."""
    import torch

    from tpu_slam_torch.distributed.registration_dist import \
        sharded_pairwise_icp
    from tpu_slam_torch.kernels.nn_search import (nearest_neighbors,
                                                  nearest_neighbors_plain)

    dev = mesh.device
    args = [torch.as_tensor(job[k], device=dev)
            for k in ("src", "src_mask", "tgt", "tgt_mask", "init")]
    plain_before = nearest_neighbors_plain.launches
    _sync()
    mesh.stats.reset()
    nearest_neighbors.launches = 0
    t0 = time.perf_counter()
    res = sharded_pairwise_icp(mesh, *args, params=job["params"])
    _sync()
    return dict(seconds=time.perf_counter() - t0,
                launches=nearest_neighbors.launches,
                plain_launches=nearest_neighbors_plain.launches
                - plain_before,
                collectives=mesh.stats.as_dict(),
                T=res.T.cpu().numpy(), iterations=res.iterations.cpu().numpy(),
                converged=res.converged.cpu().numpy())


def _rank_launches(mesh, fn, warm=False):
    """Kernel launches and host syncs of one call of ``fn`` on rank 0,
    under torch.profiler, with ``warm`` after a call unprofiled (a
    captured form's capture); the other ranks make the same calls
    unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
        _sync()
    if mesh.rank != 0:
        fn()
        _sync()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    return dict(
        kernel_launches=sum(e.count for e in ka if e.key in (
            "cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx")),
        host_syncs=sum(e.count for e in ka
                       if e.key == "aten::_local_scalar_dense"))


def dist_graph_rank(mesh, job):
    """The edge-sharded PCG and the Schur solves on the slam run's graph,
    each timed (the Schur solve in its default form: eager on gloo,
    captured on NCCL, its first call the capture); then one GN iteration
    of each float32 solve with rank 0 under the profiler (kernel launches
    an iteration; a whole PCG solve, ~70,000 launches, takes the profiler
    minutes)."""
    import dataclasses

    from tpu_slam_torch.distributed.mesh import captured_form
    from tpu_slam_torch.distributed.pose_graph_dist import \
        optimize_pose_graph_sharded
    from tpu_slam_torch.distributed.schur import optimize_pose_graph_schur

    solvers = dict(pcg=optimize_pose_graph_sharded,
                   schur=optimize_pose_graph_schur)
    out = {}
    for name, solver, params, dtype in job["solves"]:
        graph = _graph_torch(job["graph"], mesh.device, dtype)
        _sync()
        mesh.stats.reset()
        t0 = time.perf_counter()
        g, chi2 = solvers[solver](mesh, graph, params)
        _sync()
        captured = solver == "schur" and captured_form(mesh, None)
        out[name] = dict(seconds=time.perf_counter() - t0,
                         collectives=mesh.stats.as_dict(),
                         poses=g.poses.cpu().numpy(), chi2=float(chi2),
                         form="captured" if captured else "eager")
        if dtype == "float32":
            one = dataclasses.replace(params, gn_iterations=1)
            out[name]["per_gn_iteration"] = _rank_launches(
                mesh, lambda: solvers[solver](mesh, graph, one),
                warm=captured)
    return out


def _dense_rank_inputs(mesh, job):
    """This rank's x-chunk of the dense job's first window, its origin,
    pose and delta, and the scans, on the rank's device."""
    import torch

    dev = mesh.device
    dims = job["dims"]
    per = dims[0] // mesh.size * dims[1] * dims[2]
    rows0 = np.load(job["rows"], mmap_mode="r")
    rows = torch.as_tensor(np.array(rows0[mesh.rank * per:
                                          (mesh.rank + 1) * per]),
                           device=dev)
    return (rows, torch.as_tensor(job["origin_cell"], device=dev),
            torch.as_tensor(job["pose"], device=dev),
            torch.as_tensor(job["delta"], device=dev),
            [_cloud(sc, dev) for sc in job["scans"]])


def dist_compiled_rank(mesh, job):
    """The layer's compiled programs on this rank. On gloo: compiled=True
    raises for the sharded dense step and the Schur solve (gloo runs their
    eager forms). On NCCL: the dense job's steps and the graph job's
    float32 Schur solve on both forms (compiled=False, then the captured
    default, every replay under sync-debug "error"): the results, the
    seconds of each step (the first captured one with its capture) and
    solve (captured by the graph job), ndt_terms launches, one step's and
    one GN iteration's launches, graph launches and reads (run_profile),
    the graphs held."""
    import dataclasses

    from tpu_slam_torch.distributed import dense_shard, schur
    from tpu_slam_torch.distributed.mesh import captured_form
    from tpu_slam_torch.kernels.ndt_terms import ndt_terms

    dense, gjob = job["dense"], job["graph"]
    rows0, oc, pose0, delta0, scans = _dense_rank_inputs(mesh, dense)
    _, _, gparams, dtype = [x for x in gjob["solves"]
                            if x[0] == "schur"][0]
    graph = _graph_torch(gjob["graph"], mesh.device, dtype)
    spec, dims, params = dense["spec"], dense["dims"], dense["params"]

    def step(args, compiled):
        return dense_shard.dense_step_sharded(
            mesh, *args, spec, dims, params, compiled=compiled,
            **dense["gates"])

    def solve(p, compiled):
        return schur.optimize_pose_graph_schur(mesh, graph, p,
                                               compiled=compiled)

    if not captured_form(mesh, None):
        raised = []
        for fn in (lambda: step((rows0, oc, pose0, delta0, scans[0]), True),
                   lambda: solve(gparams, True)):
            try:
                fn()
                raised.append(False)
            except ValueError:
                raised.append(True)
        return dict(form="eager", compiled_true_raises=raised)

    out, kept = dict(form="captured"), {}
    for form, compiled in (("eager", False), ("captured", None)):
        reset_launches(ndt_terms)
        rows, pose, delta = rows0, pose0, delta0
        results, step_s, solve_s = [], [], []
        with replays_sync_checked() as chk:
            for scan in scans:
                args = (rows, oc, pose, delta, scan)
                _sync()
                t0 = time.perf_counter()
                rows, pose, delta, m = res = step(args, compiled)
                _sync()
                step_s.append(time.perf_counter() - t0)
                results.append(res)
            launches = launches_of(ndt_terms)
            for _ in range(2):
                _sync()
                t0 = time.perf_counter()
                results.append(solve(gparams, compiled))
                _sync()
                solve_s.append(time.perf_counter() - t0)
        kept[form] = results
        one = dataclasses.replace(gparams, gn_iterations=1)
        out[form] = dict(
            poses=np.stack([r[1].cpu().numpy() for r in results[:-2]]),
            metrics=np.stack([r[3].cpu().numpy() for r in results[:-2]]),
            step_s=step_s, ndt_terms_launches=launches,
            step_profile=run_profile(lambda: step(args, compiled), 1),
            schur_poses=results[-1][0].poses.cpu().numpy(),
            schur_chi2=[float(c) for _, c in results[-2:]],
            schur_s=solve_s,
            schur_chi2_on_device=all(c.is_cuda for _, c in results[-2:]),
            gn_iteration_profile=run_profile(lambda: solve(one, compiled),
                                             1),
            replays_checked=chk.calls)
    out["bit_equal"] = all(same_tensors(a, b) for a, b in
                           zip(kept["eager"], kept["captured"]))
    # the graphs this rank holds: the step's, and the Schur solve's for
    # each params and dtype it ran (the graph job's float32 and float64
    # solves and one-iteration profile, which this job replays)
    out["graphs"] = dict(dense_step=len(dense_shard._steps),
                         schur=len(schur._solves))
    return out


def dist_health_rank(mesh, job):
    from tpu_slam_torch.distributed.multihost import heartbeat

    t0 = time.perf_counter()
    healthy = heartbeat(mesh, timeout_s=30.0)
    healthy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    hung = heartbeat(mesh, timeout_s=job["timeout_s"],
                     _probe_fn=lambda x: time.sleep(30))
    return dict(healthy=healthy, healthy_s=healthy_s, hung=hung,
                hung_s=time.perf_counter() - t0)


def dist_rank_body(mesh, jobs):
    """A rank's whole distributed phase: each job in order, with the
    rank's device and its CUDA libraries loaded once."""
    import torch

    from tpu_slam_torch.kernels import _build

    for name in sorted(p.stem for p in _build.CSRC.glob("*.cu")):
        _build.load(name)
    run = dict(map=dist_map_rank, dense=dist_dense_rank, icp=dist_icp_rank,
               graph=dist_graph_rank, health=dist_health_rank,
               compiled=dist_compiled_rank)
    out = dict(device=str(mesh.device), backend=mesh.backend)
    for name, job in jobs:
        torch.cuda.reset_peak_memory_stats()
        out[name] = run[name](mesh, job)
        out[name]["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out


def nccl_pair_probe(mesh):
    """Two NCCL ranks on one card: one all-reduce."""
    import torch

    from tpu_slam_torch.distributed import mesh as M

    return M.all_reduce(mesh, torch.ones(4, device=mesh.device))


def dist_map_job(w, tmpdir):
    """Config 5 at config 3's scale: the map split by slab_owner into
    DIST_RANKS stacked shards on disk (each rank loads its own), the street
    scan in the world frame, the bench's perturbed source; and the single
    device's insert and registration on the same inputs."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.distributed import map_shard as ms
    from tpu_slam_torch.mapping.voxel_map import insert_cloud
    from tpu_slam_torch.registration.ndt import ndt_field, ndt_register

    vmap, spec, Tw = w["vmap"], w["map_spec"], w["Tw"]
    dev = Tw.device
    params = dist_map_params()
    world = w["cloud"].transform(Tw)
    owner = ms.slab_owner(vmap.keys, spec, DIST_RANKS)
    n_slab = [int((owner == d).sum()) for d in range(DIST_RANKS)]
    cap = -(-(max(n_slab) + w["cloud"].capacity) // 4096) * 4096
    # the shards of the 4-way split, and the whole map as one shard (world
    # size 1), each as (D, C, ...) arrays under tmpdir/<D>/
    for n in (DIST_RANKS, 1):
        os.makedirs(f"{tmpdir}/{n}")
    for f in ms.MAP_FIELDS:
        full = getattr(vmap, f)
        np.save(f"{tmpdir}/1/{f}.npy", full.cpu().numpy()[None])
        rows = []
        for d in range(DIST_RANKS):
            fill = (np.iinfo(np.int32).max if f == "keys"
                    else -np.inf if f == "stamp" else 0.0)
            a = np.full((cap,) + tuple(full.shape[1:]), fill,
                        full.cpu().numpy().dtype)
            part = full[owner == d].cpu().numpy()
            a[:len(part)] = part
            rows.append(a)
        np.save(f"{tmpdir}/{DIST_RANKS}/{f}.npy", np.stack(rows))
    E = se3.exp(torch.tensor(C3_XI, dtype=torch.float32, device=dev))
    src = w["scan"].transform(se3.inverse(E))
    center = Tw[:3, 3]
    job = dict(dir=tmpdir, spec=spec, params=params, stamp=1.0,
               world=(world.points.cpu().numpy(), world.mask.cpu().numpy()),
               src=(src.points.cpu().numpy(), src.mask.cpu().numpy()),
               init=Tw.cpu().numpy(), center=center.cpu().numpy(),
               regs=DIST_MAP_REGS)

    single = insert_cloud(vmap, world, spec, 1.0, incremental=False)

    def register():
        # the field is part of a registration, as in ndt_register_sharded
        field = ndt_field(single, spec, params, center=center)
        return ndt_register(src, field, spec, init_T=Tw, params=params)

    res = register()
    _sync()
    t0 = time.perf_counter()
    for _ in range(DIST_MAP_REGS):
        register()
    _sync()
    regs_per_s = DIST_MAP_REGS / (time.perf_counter() - t0)
    T_true = Tw @ E
    err = se3.log(se3.inverse(T_true) @ res.T)
    sowner = ms.slab_owner(single.keys, spec, DIST_RANKS)
    ref = dict(T=res.T.cpu().numpy(), score=float(res.score),
               matched=float(res.matched_fraction),
               iterations=int(res.iterations), regs_per_s=regs_per_s,
               err_mm=float(torch.linalg.vector_norm(err[:3])) * 1e3,
               T_true=T_true.cpu().numpy(),
               slab_keys=[single.keys[sowner == d].cpu().numpy()
                          for d in range(DIST_RANKS)],
               slab_count=[single.count[sowner == d].cpu().numpy()
                           for d in range(DIST_RANKS)],
               map_voxels=int(single.n_occupied()), slab_voxels=n_slab,
               shard_capacity=cap)
    return job, ref


def dist_dense_job(clouds, gt, tmpdir):
    """dist_config2's engine on ``clouds`` (config 2's scans through the
    turn: on the straight street the fine window alone slides along it
    without the coarse pyramid, in the single engine as in the sharded
    step): its first window (on disk, for the ranks' chunks), the
    downsampled and range-gated scans it registers, and its poses and
    metrics."""
    import dataclasses

    import torch

    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry

    cfg = dist_config2()
    od = DenseLidarOdometry(cfg, device=clouds[0].points.device)
    state = od.init_state(clouds[0], gt[0])
    # the route's first motion as the constant-velocity seed: without the
    # coarse pyramid a 1.6 m step from a standing start is out of the fine
    # window's capture range
    delta0 = (np.linalg.inv(np.asarray(gt[0], np.float64))
              @ np.asarray(gt[1], np.float64)).astype(np.float32)
    state = dataclasses.replace(state, last_delta=torch.as_tensor(
        delta0, device=state.pose.device))
    np.save(f"{tmpdir}/dense_rows.npy", state.grid.rows.cpu().numpy())
    job = dict(rows=f"{tmpdir}/dense_rows.npy", delta=delta0,
               origin_cell=state.grid.origin_cell.cpu().numpy(),
               pose=np.asarray(gt[0], np.float32), dims=cfg.ndt.window_dims,
               spec=cfg.map_spec(), params=cfg.ndt, scans=[],
               gates=dict(min_accept_fraction=cfg.min_accept_fraction,
                          min_insert_fraction=cfg.min_insert_fraction,
                          max_pred_translation=cfg.max_pred_translation,
                          max_pred_rotation=cfg.max_pred_rotation))
    poses, metrics = [], []
    t0 = time.perf_counter()
    for c in clouds[1:DIST_DENSE_STEPS + 1]:
        # the scan the engine registers (DenseLidarOdometry.step)
        scan = od.downsample(c)
        rng2 = torch.sum(scan.points[:, :2] ** 2, dim=1)
        scan = PointCloud(points=scan.points,
                          mask=scan.mask & (rng2 < cfg.scan_max_range ** 2),
                          attrs=scan.attrs).sanitize()
        job["scans"].append((scan.points.cpu().numpy(),
                             scan.mask.cpu().numpy()))
        state = od.step(state, c)
        poses.append(state.pose.cpu().numpy())
        metrics.append(state.last_metrics.cpu().numpy())
    _sync()
    poses = np.stack(poses)
    gt_t = np.asarray(gt[1:DIST_DENSE_STEPS + 1])[:, :3, 3]
    return job, dict(poses=poses, metrics=np.stack(metrics),
                     seconds=time.perf_counter() - t0, gt_t=gt_t,
                     ate_m=float(np.sqrt(np.mean(np.sum(
                         (poses[:, :3, 3] - gt_t) ** 2, axis=1)))))


def dist_icp_job(run):
    """The slam run's verification batch (its first DIST_ICP_PAIRS loop
    pairs: source keyframe j, target i, init T_i^-1 T_j) and the port's
    batched icp on it."""
    import torch

    from tpu_slam_torch.core import se3
    from tpu_slam_torch.core.pointcloud import PointCloud
    from tpu_slam_torch.registration.icp import icp

    state = run["state"]
    pairs = sorted(state.loop_pairs)[:DIST_ICP_PAIRS]
    dev = state.kf_points.device
    ci = torch.as_tensor([p[0] for p in pairs], device=dev)
    cj = torch.as_tensor([p[1] for p in pairs], device=dev)
    init = se3.inverse(state.graph.poses[ci]) @ state.graph.poses[cj]
    params = config4().loop.icp
    args = dict(src=state.kf_points[cj], src_mask=state.kf_mask[cj],
                tgt=state.kf_points[ci], tgt_mask=state.kf_mask[ci],
                init=init)
    _sync()
    t0 = time.perf_counter()
    res = icp(PointCloud(points=args["src"], mask=args["src_mask"]),
              PointCloud(points=args["tgt"], mask=args["tgt_mask"]),
              init_T=init, params=params)
    _sync()
    job = {k: v.cpu().numpy() for k, v in args.items()}
    job["params"] = params
    return job, dict(T=res.T.cpu().numpy(),
                     iterations=res.iterations.cpu().numpy(),
                     converged=res.converged.cpu().numpy(),
                     seconds=time.perf_counter() - t0, pairs=pairs)


def dist_graph_job(run):
    """The slam run's final graph and the single-device solves of it: the
    PCG, and the dense solve in float32 and float64 on both forms (the
    captured one's capture apart, its replay under sync-debug "error",
    bit-equal to compiled=False: raises if not); a solve's seconds are one
    solve's, a replay's for the dense one."""
    from tpu_slam_torch.graph.pose_graph import optimize_pose_graph

    graph = run["state"].graph
    gnp = _graph_numpy(graph)
    ref = {}
    for name, _, p, dtype in dist_graph_solves():
        # the PCG against the single-device PCG, the Schur solves against
        # the dense solve (their params say solver="dense")
        g_in = _graph_torch(gnp, graph.poses.device, dtype)
        if p.solver == "dense":
            res, secs, checked = dense_solve_forms(g_in, p)
            g, chi2 = res["captured"]
            ref[name] = dict(seconds=secs["captured"], dense_forms=dict(
                seconds=secs, replays_checked=checked,
                bit_equal=same_tensors(res["eager"], res["captured"])))
            if not (ref[name]["dense_forms"]["bit_equal"] and checked == 1):
                raise AssertionError(f"dist_graph's {name} reference: the "
                                     f"captured dense solve "
                                     f"{ref[name]['dense_forms']}")
        else:
            _sync()
            t0 = time.perf_counter()
            g, chi2 = optimize_pose_graph(g_in, p)
            _sync()
            ref[name] = dict(seconds=time.perf_counter() - t0)
        ref[name].update(poses=g.poses.cpu().numpy(), chi2=float(chi2),
                         solver=p.solver)
    return dict(graph=gnp, solves=dist_graph_solves()), dict(
        ref, n_nodes=int(graph.n_nodes),
        node_capacity=graph.node_capacity,
        edge_capacity=graph.edge_capacity,
        edges=int(graph.edge_mask.sum()))


def _dist_check_map(got, ref, label, n):
    """Every rank's insert against the single map's slab rows (ranks of a
    4-way split; world size 1 holds the whole map), the registration
    against the single device."""
    for r, out in enumerate(got):
        if n == DIST_RANKS:
            want_k, want_c = ref["slab_keys"][r], ref["slab_count"][r]
        else:
            want_k = np.concatenate(ref["slab_keys"])
            want_c = np.concatenate(ref["slab_count"])
        m = out["map"]
        if not (np.array_equal(m["keys"], want_k)
                and np.array_equal(m["count"], want_c)):
            raise AssertionError(f"{label}: rank {r}'s keys or counts differ "
                                 "from the single map's slab")
        if m["plain_launches"] or m["launches"] <= 0:
            raise AssertionError(f"{label}: rank {r} ran the plain terms or "
                                 "no ndt_terms kernel")
    m = got[0]["map"]
    d_pose = float(np.abs(m["T"] - ref["T"]).max())
    if not d_pose <= DIST_MAP_POSE_TOL:
        raise AssertionError(f"{label}: pose {d_pose} from the single "
                             "device's")
    if not abs(m["score"] - ref["score"]) <= DIST_MAP_SCORE_TOL:
        raise AssertionError(f"{label}: score {m['score']} vs {ref['score']}")
    if m["matched"] != ref["matched"]:
        raise AssertionError(f"{label}: matched {m['matched']} != single "
                             f"{ref['matched']}")
    return d_pose


def _dist_check_icp(got, ref, label):
    for r, out in enumerate(got):
        if out["icp"]["plain_launches"] or out["icp"]["launches"] <= 0:
            raise AssertionError(f"{label}: rank {r} ran the plain NN or "
                                 "no nn_search kernel")
    i = got[0]["icp"]
    d_T = float(np.abs(i["T"] - ref["T"]).max())
    if not d_T <= DIST_ICP_T_TOL:
        raise AssertionError(f"{label}: T {d_T} from the batched icp's")
    if not np.array_equal(i["converged"], ref["converged"]):
        raise AssertionError(f"{label}: converged flags differ")
    return d_T


def _dist_check_graph(got, ref, label):
    """PCG against the single-device PCG, the float64 Schur solve against
    the float64 dense solve, and the float32 Schur solve against both the
    float32 and the float64 dense solve, each at the reference tests'
    bars. Returns (errors, failures)."""
    out, failed = {}, []
    n = ref["n_nodes"]
    schur = (DIST_SCHUR_POSE_TOL, DIST_SCHUR_CHI2_RTOL)
    for key, name, want, (ptol, ctol) in (
            ("pcg", "pcg", "pcg", (DIST_PCG_POSE_TOL, DIST_PCG_CHI2_RTOL)),
            ("schur64", "schur64", "schur64", schur),
            ("schur", "schur", "schur", schur),
            ("schur_vs_dense_f64", "schur", "schur64", schur)):
        g, w = got[0]["graph"][name], ref[want]
        d_pose = float(np.abs(g["poses"][:n] - w["poses"][:n]).max())
        d_chi = abs(g["chi2"] - w["chi2"]) / max(w["chi2"], 1.0)
        if not (d_pose <= ptol and d_chi <= ctol):
            failed.append(f"{label} {key}: poses {d_pose} (bar {ptol}), "
                          f"chi2 {d_chi} (bar {ctol})")
        out[key] = dict(pose_err=d_pose, pose_bar=ptol, chi2_rel_err=d_chi)
    return out, failed


def _bit_identical(got, key, fields):
    from tpu_slam_torch.distributed.mesh import rank_results_equal

    return rank_results_equal([{f: out[key][f] for f in fields}
                               for out in got])


def schur_single(graph_job, graph_ref):
    """optimize_pose_graph_schur(None, ...) on the slam run's graph in
    float32 (dist_graph's "schur" params) on both forms (compiled=False,
    then the captured default, its replays under sync-debug "error"):
    poses and chi^2 bit for bit and against the dense solve, the seconds
    of a solve (the capture apart), the captured form's launches, graph
    launches and reads a GN iteration (run_profile; the NCCL rank
    profiles the eager form's, the same program), the captures made."""
    import dataclasses

    from tpu_slam_torch.distributed import schur

    _, _, params, dtype = [x for x in graph_job["solves"]
                           if x[0] == "schur"][0]
    graph = _graph_torch(graph_job["graph"], "cuda", dtype)
    one = dataclasses.replace(params, gn_iterations=1)
    n = graph_ref["n_nodes"]
    before = cache_replays(schur._solves)
    row, res = {}, {}
    for form, compiled in (("eager", False), ("captured", None)):
        t0 = time.perf_counter()
        schur.optimize_pose_graph_schur(None, graph, params,
                                        compiled=compiled)
        _sync()
        first_s = time.perf_counter() - t0
        with replays_sync_checked() as chk:
            t0 = time.perf_counter()
            res[form] = schur.optimize_pose_graph_schur(
                None, graph, params, compiled=compiled)
            _sync()
            solve_s = time.perf_counter() - t0
        g, chi2 = res[form]
        want = graph_ref["schur"]
        row[form] = dict(
            first_call_s=first_s, solve_s=solve_s,
            solve_s_per_gn_iteration=solve_s / params.gn_iterations,
            replays_checked=chk.calls, chi2_on_device=chi2.is_cuda,
            pose_err_vs_dense=float(np.abs(g.poses.cpu().numpy()[:n]
                                           - want["poses"][:n]).max()),
            chi2_rel_err_vs_dense=abs(float(chi2) - want["chi2"])
            / max(want["chi2"], 1.0))
        if compiled is None:
            row[form]["gn_iteration"] = run_profile(
                lambda: schur.optimize_pose_graph_schur(None, graph, one),
                1)
    row["bit_equal"] = same_tensors(res["eager"], res["captured"])
    row["use"] = cache_use(schur._solves, before)
    return row


def phase_distributed(run, w3, dense_job, dense_ref):
    """The distributed layer at full width: DIST_RANKS gloo ranks on this
    card (time-sharing it), then world size 1 on NCCL; every result against
    the single device's on the same inputs. Returns (ndt_terms launches by
    path, nn_search launches by path, ndt_terms cases, nn_search cases)."""
    import torch

    from tpu_slam_torch.distributed.mesh import run_ranks
    from tpu_slam_torch.kernels.ndt_terms import TermsSlots

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmpdir:
        t0 = time.perf_counter()
        map_job, map_ref = dist_map_job(w3, tmpdir)
        icp_job, icp_ref = dist_icp_job(run)
        graph_job, graph_ref = dist_graph_job(run)
        prep_s = time.perf_counter() - t0
        health = dict(timeout_s=DIST_HEARTBEAT_TIMEOUT_S)
        compiled_job = dict(dense=dense_job, graph=graph_job)
        jobs = [("map", map_job), ("dense", dense_job), ("icp", icp_job),
                ("graph", graph_job), ("health", health),
                ("compiled", compiled_job)]
        t0 = time.perf_counter()
        got = run_ranks(dist_rank_body, DIST_RANKS, jobs, backend="gloo",
                        device="cuda", threads=2, timeout_s=600)
        gloo_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = run_ranks(dist_rank_body, 1,
                         [("map", map_job), ("icp", icp_job),
                          ("graph", graph_job), ("compiled", compiled_job)],
                         backend="nccl", device="cuda", threads=2,
                         timeout_s=600)
        nccl_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        single = schur_single(graph_job, graph_ref)
        single_s = time.perf_counter() - t0
    # NCCL and two ranks on one card: what it says
    t0 = time.perf_counter()
    try:
        run_ranks(nccl_pair_probe, 2, backend="nccl", device="cuda",
                  timeout_s=90)
        nccl_two = "ran"
    except (RuntimeError, TimeoutError) as e:
        nccl_two = str(e).strip().splitlines()[-1][:300]
    nccl_two_s = time.perf_counter() - t0

    # dist_map
    d_map = _dist_check_map(got, map_ref, "dist_map", DIST_RANKS)
    if not _bit_identical(got, "map", ("T", "score", "matched")):
        raise AssertionError("dist_map: ranks disagree")
    m = got[0]["map"]
    map_launches = sum(out["map"]["launches"] for out in got)
    emit("distributed", case="dist_map", ranks=DIST_RANKS, backend="gloo",
         map_voxels=map_ref["map_voxels"], slab_voxels=map_ref["slab_voxels"],
         shard_capacity=map_ref["shard_capacity"],
         window=list(C3_FINE), planes_per_rank=C3_FINE[0] // DIST_RANKS,
         pose_err_vs_single=d_map,
         score=m["score"], single_score=map_ref["score"],
         matched=m["matched"], single_matched=map_ref["matched"],
         iterations=m["iterations"], single_iterations=map_ref["iterations"],
         err_mm_vs_truth=float(np.linalg.norm(
             (np.linalg.inv(map_ref["T_true"]) @ m["T"])[:3, 3])) * 1e3,
         single_err_mm_vs_truth=map_ref["err_mm"],
         registration_s=m["seconds"], regs_per_s=m["regs_per_s"],
         single_regs_per_s=map_ref["regs_per_s"],
         rate_caveat=("4 ranks time-share one card and stage every "
                      "collective through host memory (gloo): this rate "
                      "measures the sharding overhead, not scaling"),
         collectives_a_registration=m["collectives"],
         ndt_terms_launches_by_rank=[o["map"]["launches"] for o in got],
         profile_rank0=m["profile"],
         peak_memory_bytes_by_rank=[o["map"]["peak_memory_bytes"]
                                    for o in got])
    # dist_dense
    dd = [out["dense"] for out in got]
    if not _bit_identical(got, "dense", ("poses", "metrics")):
        raise AssertionError("dist_dense: ranks disagree")
    if any(d["plain_launches"] or d["launches"] <= 0 for d in dd):
        raise AssertionError("dist_dense: a rank ran the plain terms")
    step_err = np.abs(dd[0]["poses"] - dense_ref["poses"]).max(axis=(1, 2))
    emit("distributed", case="dist_dense", ranks=DIST_RANKS, backend="gloo",
         window=list(dense_job["dims"]), steps=DIST_DENSE_STEPS,
         pose_err_by_step=step_err.tolist(),
         iterations=dd[0]["metrics"][:, 0].tolist(),
         single_iterations=dense_ref["metrics"][:, 0].tolist(),
         matched=dd[0]["metrics"][:, 1].tolist(),
         single_matched=dense_ref["metrics"][:, 1].tolist(),
         inserted=dd[0]["metrics"][:, 3].tolist(),
         ate_m=float(np.sqrt(np.mean(np.sum(
             (dd[0]["poses"][:, :3, 3] - dense_ref["gt_t"]) ** 2, axis=1)))),
         single_ate_m=dense_ref["ate_m"],
         step_s=dd[0]["step_s"], single_seconds=dense_ref["seconds"],
         rate_caveat="4 ranks time-share one card: overhead, not scaling",
         collectives=dd[0]["collectives"],
         ndt_terms_launches_by_rank=[d["launches"] for d in dd])
    if not step_err.max() <= DIST_DENSE_POSE_TOL:
        raise AssertionError(f"dist_dense: pose error by step {step_err}")
    # dist_icp
    d_icp = _dist_check_icp(got, icp_ref, "dist_icp")
    if not _bit_identical(got, "icp", ("T", "iterations", "converged")):
        raise AssertionError("dist_icp: ranks disagree")
    emit("distributed", case="dist_icp", ranks=DIST_RANKS, backend="gloo",
         pairs=len(icp_ref["pairs"]), padded_to=-(-len(icp_ref["pairs"])
                                                  // DIST_RANKS) * DIST_RANKS,
         points=int(icp_job["src"].shape[1]), T_err_vs_batched=d_icp,
         converged=got[0]["icp"]["converged"].tolist(),
         iterations=got[0]["icp"]["iterations"].tolist(),
         seconds=got[0]["icp"]["seconds"],
         single_seconds=icp_ref["seconds"],
         nn_search_launches_by_rank=[o["icp"]["launches"] for o in got],
         collectives=got[0]["icp"]["collectives"])
    # dist_graph
    g_err, g_failed = _dist_check_graph(got, graph_ref, "dist_graph")
    if not all(np.array_equal(o["graph"][k]["poses"],
                              got[0]["graph"][k]["poses"])
               for o in got for k in ("pcg", "schur", "schur64")):
        raise AssertionError("dist_graph: ranks disagree")
    emit("distributed", case="dist_graph", ranks=DIST_RANKS, backend="gloo",
         n_nodes=graph_ref["n_nodes"],
         node_capacity=graph_ref["node_capacity"],
         edge_capacity=graph_ref["edge_capacity"], edges=graph_ref["edges"],
         errors=g_err,
         solve_ms={k: got[0]["graph"][k]["seconds"] * 1e3
                   for k in ("pcg", "schur", "schur64")},
         single_solve_ms={k: graph_ref[k]["seconds"] * 1e3
                          for k in ("pcg", "schur", "schur64")},
         single_dense_forms={k: graph_ref[k]["dense_forms"]
                             for k in ("schur", "schur64")},
         launches_a_gn_iteration_rank0={
             k: got[0]["graph"][k]["per_gn_iteration"]
             for k in ("pcg", "schur")},
         collectives={k: got[0]["graph"][k]["collectives"]
                      for k in ("pcg", "schur")})
    if g_failed:
        raise AssertionError("; ".join(g_failed))
    # dist_health
    hh = [out["health"] for out in got]
    emit("distributed", case="dist_health", ranks=DIST_RANKS,
         healthy=[h["healthy"] for h in hh],
         healthy_s=[h["healthy_s"] for h in hh],
         hung=[h["hung"] for h in hh], hung_s=[h["hung_s"] for h in hh],
         timeout_s=DIST_HEARTBEAT_TIMEOUT_S)
    if not all(h["healthy"] is True and h["hung"] is False
               and h["hung_s"] < DIST_HEARTBEAT_TIMEOUT_S + 5.0 for h in hh):
        raise AssertionError("dist_health: heartbeat failed")
    # world size 1 on NCCL
    n_map = _dist_check_map(nccl, map_ref, "nccl_map", 1)
    n_icp = _dist_check_icp(nccl, icp_ref, "nccl_icp")
    n_graph, n_failed = _dist_check_graph(nccl, graph_ref, "nccl_graph")
    c = nccl[0]
    emit("distributed", case="nccl_world_1", backend=c["backend"],
         device=c["device"],
         nccl=".".join(map(str, torch.cuda.nccl.version())),
         map_pose_err=n_map, map_bit_equal=bool(
             np.array_equal(c["map"]["T"], map_ref["T"])
             and c["map"]["score"] == map_ref["score"]),
         map_regs_per_s=c["map"]["regs_per_s"],
         map_collectives=c["map"]["collectives"],
         icp_T_err=n_icp, icp_bit_equal=bool(
             np.array_equal(c["icp"]["T"], icp_ref["T"])),
         graph_errors=n_graph, graph_solve_ms={
             k: c["graph"][k]["seconds"] * 1e3 for k in ("pcg", "schur")},
         staged_bytes=c["map"]["collectives"]["staged_bytes"],
         two_ranks_one_card=nccl_two, two_ranks_probe_s=nccl_two_s)
    if n_failed:
        raise AssertionError("; ".join(n_failed))
    if c["backend"] != "nccl" or c["map"]["collectives"]["staged_copies"]:
        raise AssertionError("nccl_world_1: not on NCCL or staged")
    # the compiled programs: gloo's refusal of compiled=True, the NCCL
    # rank's two forms, the single-process Schur solve's
    cc = c["compiled"]
    step_err = np.abs(cc["captured"]["poses"]
                      - dense_ref["poses"]).max(axis=(1, 2))
    emit("distributed", case="compiled",
         gloo=dict(form=got[0]["compiled"]["form"],
                   compiled_true_raises=[o["compiled"]["compiled_true_raises"]
                                         for o in got]),
         nccl=dict(form=cc["form"], bit_equal=cc["bit_equal"],
                   graphs=cc["graphs"],
                   pose_err_vs_single_by_step=step_err.tolist(),
                   matched=cc["captured"]["metrics"][:, 1].tolist(),
                   single_matched=dense_ref["metrics"][:, 1].tolist(),
                   **{form: {k: v for k, v in cc[form].items()
                             if k not in ("poses", "metrics",
                                          "schur_poses")}
                      for form in ("eager", "captured")}),
         schur_single=single, graph_forms={
             k: c["graph"][k]["form"] for k in ("pcg", "schur", "schur64")})
    failed = []
    if not all(all(o["compiled"]["compiled_true_raises"]) for o in got):
        failed.append("compiled=True on gloo did not raise")
    if not (cc["bit_equal"] and single["bit_equal"]):
        failed.append(f"a captured distributed program differs from its "
                      f"eager form: NCCL {cc['bit_equal']}, single-process "
                      f"Schur {single['bit_equal']}")
    if (cc["graphs"] != dict(dense_step=1, schur=3)
            or single["use"]["captured"] != 2):
        failed.append(f"captures: NCCL {cc['graphs']} (want the step's and "
                      f"three Schur signatures'), single-process "
                      f"{single['use']} (want the solve and its "
                      "one-iteration profile)")
    if not cc["captured"]["replays_checked"] or not single["captured"][
            "replays_checked"]:
        failed.append("no captured call was checked under sync-debug")
    if not step_err.max() <= DIST_DENSE_POSE_TOL:
        failed.append(f"nccl dense: pose error by step {step_err}")
    if not (single["captured"]["pose_err_vs_dense"] <= DIST_SCHUR_POSE_TOL
            and single["captured"]["chi2_rel_err_vs_dense"]
            <= DIST_SCHUR_CHI2_RTOL):
        failed.append(f"single-process Schur against the dense solve: "
                      f"{single['captured']}")
    if failed:
        raise AssertionError("; ".join(failed))
    terms_launches = dict(dist_map=map_launches,
                          dist_dense=sum(d["launches"] for d in dd),
                          nccl_map=c["map"]["launches"],
                          nccl_dense=sum(cc[f]["ndt_terms_launches"]
                                         for f in ("eager", "captured")))
    nn_launches = dict(dist_icp=sum(o["icp"]["launches"] for o in got),
                       nccl_icp=c["icp"]["launches"])

    # the kernels at the distributed path's shapes: rank 0's share of the
    # terms pass, and nn_search on rank 0's verification shard
    dev = torch.device("cuda")
    k = got[0]["map"]["case"]
    slots = TermsSlots(points=torch.as_tensor(k["points"], device=dev),
                       cell=torch.as_tensor(k["cell"], device=dev),
                       valid=torch.as_tensor(k["valid"], device=dev),
                       inside=torch.as_tensor(k["valid"], device=dev))
    terms_cases = [check_terms_case("dist_map_rank0_share", (
        slots, torch.as_tensor(k["rows"], device=dev),
        torch.as_tensor(k["T"], device=dev), k["gamma"], k["max_corr"],
        tuple(k["dims"])))]
    per = -(-len(icp_ref["pairs"]) // DIST_RANKS)
    q = torch.as_tensor(icp_job["src"][:per], device=dev)
    init = torch.as_tensor(icp_job["init"][:per], device=dev)
    qm = torch.as_tensor(icp_job["src_mask"][:per], device=dev)
    tm = torch.as_tensor(icp_job["tgt_mask"][:per], device=dev)
    from tpu_slam_torch.core import se3
    q = torch.where(qm[..., None], se3.apply(init, q), 1e8).contiguous()
    t = torch.where(tm[..., None], torch.as_tensor(
        icp_job["tgt"][:per], device=dev), 1e8).contiguous()
    nn_cases = [check_nn_case("dist_icp_rank0_shard", q, t, qm, tm)]
    emit("kernels", kernels=["ndt_terms", "nn_search"],
         cases=terms_cases + nn_cases, rtol_of_max=RTOL_OF_MAX)
    emit("distributed_total", seconds=time.perf_counter() - t_phase,
         prepare_s=prep_s, gloo_ranks_s=gloo_s, nccl_rank_s=nccl_s,
         part_seconds=dict(prepare=prep_s, gloo_ranks=gloo_s,
                           nccl_rank=nccl_s, schur_single=single_s,
                           nccl_two_ranks=nccl_two_s))
    return terms_launches, nn_launches, terms_cases, nn_cases


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
    del engine

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
    # the captured step and solve against the eager ones
    phase_compiled(clouds, gt, run, c4_clouds, c4_gt)
    nn_cases = phase_nn_kernels(run)
    pcg_cases = phase_pcg_kernel(run)

    icp_launches, nn_c1_launches, pairs, c1_rates = phase_pair_icp()
    icp_cases, nn_c1_cases = phase_icp_kernels(pairs)
    gather_launches, gather_cases = phase_probes()

    # this slice's paths: the engine's options on config 2's scans, then
    # configs 3 and 6
    options_launches = phase_options(clouds, gt)
    # the distributed phase's dense step: config 2's scans through the
    # turn in the single-device engine at pyramid_factor 1 (its reference)
    dist_dir = tempfile.TemporaryDirectory()
    first = DIST_DENSE_FIRST
    dense_job, dense_ref = dist_dense_job(
        clouds[first:first + DIST_DENSE_STEPS + 1],
        gt[first:first + DIST_DENSE_STEPS + 1], dist_dir.name)
    # the host engine (sparse voxel map): config 2's route, the reference's
    # own cases, SLAM on it, then its kernel cases
    t_host = time.perf_counter()
    host_launches, host_fine_args = phase_host_odometry(clouds, gt)
    case_launches, cube_args, nn_args = phase_host_engine_cases(clouds, gt)
    with tempfile.TemporaryDirectory() as tmpdir:
        slam_host_launches = phase_slam_host(tmpdir)
    host_terms_cases, host_nn_cases = phase_host_kernels(
        host_fine_args, cube_args, nn_args)
    del host_fine_args, cube_args, nn_args
    emit("host_phases_total", seconds=time.perf_counter() - t_host)

    w3 = config3_workload("cuda")
    c3_launches, c3_cases = phase_config3(w3)
    # the registration layer's captured programs against their eager forms
    reg_launches = phase_compiled_registration(clouds, gt, w3, pairs,
                                               c1_rates)
    # config 2's first scans for compiled_host's host-engine options
    host_clouds = clouds[:HOST_OPTION_SCANS]
    host_gt = gt[:HOST_OPTION_SCANS]
    del clouds
    with tempfile.TemporaryDirectory() as tmpdir:
        c6_launches = phase_config6(tmpdir)

    # the distributed layer: config 5 on config 3's map, the sharded dense
    # step, ICP batch, pose-graph solvers and heartbeat
    (dist_terms_launches, dist_nn_launches, dist_terms_cases,
     dist_nn_cases) = phase_distributed(run, w3, dense_job, dense_ref)
    del w3, dense_job, dense_ref
    dist_dir.cleanup()

    # the rotating unit's live chain and the extrinsic calibration
    t_live = time.perf_counter()
    live_launches, live_terms_args, live_nn_args, survey = phase_live()
    # the live SLAM path's captured programs against their eager forms
    slam_launches = phase_compiled_slam(survey, run["state"], pairs,
                                        c1_rates)
    # the default SLAM's loop sweep and the host engine's options
    host_prog_launches = phase_compiled_host(survey, host_clouds, host_gt)
    del survey, host_clouds
    with tempfile.TemporaryDirectory() as tmpdir:
        cli_launches = phase_live_cli(tmpdir)
    live_terms_cases, live_nn_cases = phase_live_kernels(live_terms_args,
                                                         live_nn_args)
    del live_terms_args, live_nn_args
    phase_calibration()
    emit("live_phases_total", seconds=time.perf_counter() - t_live)

    terms_launches = dict(config2=launches, config2_occupancy=options_launches,
                          config3=c3_launches, config6=c6_launches,
                          host_odometry=host_launches,
                          host_engine_cases=case_launches["ndt_terms"],
                          slam_host=slam_host_launches["ndt_terms"],
                          live=live_launches["ndt_terms"],
                          live_cli=cli_launches["ndt_terms"],
                          compiled_registration=reg_launches["ndt_terms"],
                          compiled_slam=slam_launches["ndt_terms"],
                          compiled_host=host_prog_launches["ndt_terms"],
                          **dist_terms_launches)
    nn_launches = dict(config4=run["nn_launches"], config1=nn_c1_launches,
                       host_engine_cases=case_launches["nn_search"],
                       slam_host=slam_host_launches["nn_search"],
                       live=live_launches["nn_search"],
                       live_cli=cli_launches["nn_search"],
                       compiled_registration=reg_launches[
                           "nearest_neighbors"],
                       compiled_slam=slam_launches["nearest_neighbors"],
                       compiled_host=host_prog_launches["nearest_neighbors"],
                       **dist_nn_launches)

    emit("total", seconds=time.perf_counter() - t_start)
    by_case = {c["case"]: c for c in gather_cases}
    src = "tpu_slam_torch/csrc/"
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [
        # ndt_terms: no single PyTorch call computes it
        dict(kernel_entry("ndt_terms", src + "ndt_terms.cu",
                          "tpu_slam/kernels/ndt_terms.py:199",
                          sum(terms_launches.values()),
                          cases + c3_cases + host_terms_cases
                          + live_terms_cases + dist_terms_cases,
                          cases[0]), launches_by_path=terms_launches),
        # launches on all of its paths: config 4's verification, config
        # 1's brute tier, the host engine's ICP and SLAM verification, the
        # live survey's verification, the sharded verification batch
        dict(kernel_entry("nn_search", src + "nn_search.cu",
                          "tpu_slam/kernels/nn_search.py:57",
                          sum(nn_launches.values()),
                          nn_cases + nn_c1_cases + host_nn_cases
                          + live_nn_cases + dist_nn_cases,
                          nn_cases[0]), launches_by_path=nn_launches),
        # icp_terms: no single PyTorch call computes it; config 1's
        # captured and eager raster tier, then both again in
        # compiled_registration
        dict(kernel_entry("icp_terms", src + "icp_terms.cu",
                          "tpu_slam/kernels/icp_terms.py:47",
                          icp_launches + reg_launches["icp_terms_raster"],
                          icp_cases, icp_cases[1]),
             launches_by_path=dict(
                 config1=icp_launches,
                 compiled_registration=reg_launches["icp_terms_raster"])),
        # pcg_chunk: the reference's CG loop is XLA ops; the launches of
        # the slam phase's sweep solves and final refinement
        dict(kernel_entry("pcg_chunk", src + "pcg_chunk.cu",
                          "none: tpu_slam/graph/pose_graph.py _solve_pcg's "
                          "CG loop (XLA ops)", run["pcg_launches"],
                          pcg_cases, pcg_cases[0]),
             launches_by_path=dict(config4=run["pcg_launches"])),
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
                     [c for c in gather_cases
                      if c["kernel"] == "gather_row_sum"],
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
