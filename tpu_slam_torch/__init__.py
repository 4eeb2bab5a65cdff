"""tpu_slam_torch — the dense-window LiDAR SLAM engine in PyTorch + CUDA.

A port of the JAX package ``tpu_slam`` to PyTorch on an NVIDIA H100. Module
paths and public names follow ``tpu_slam`` so each function's counterpart is
easy to find; the JAX package stays the reference and this package imports
nothing of it (nor of JAX).

Layer map (every module of ``tpu_slam`` has its counterpart here, but
``utils/tpu_env``, which sets libtpu's compile environment):

    distributed/   one rank per device on torch.distributed: the
                   collectives (mesh), bring-up and heartbeat (multihost),
                   the x-slab sharded voxel map and NDT against it
                   (map_shard, config 5), the sharded dense-window step
                   (dense_shard), sharded pair ICP, the edge-sharded PCG
                   and the range-sharded Schur pose-graph solves
    cli/           run_odometry (--bag/--dataset, --engine sparse|dense),
                   run_slam (checkpoint/resume), run_live, run_calibration,
                   make_dataset, pcap_convert; --device, config overrides
    pipeline/      SLAMSystem (keyframes, loop sweeps, graph, re-anchor),
                   LidarOdometry and JitLidarOdometry (sparse voxel map),
                   DenseLidarOdometry (occupancy eviction, deskew), the live
                   pipeline (native poller -> feeder -> frame chain ->
                   aggregator -> SLAM), config, metrics, state hand-over,
                   checkpoint/resume
    graph/         pose graph (GN + matrix-free PCG), loop-closure
                   candidates and batched symmetric ICP verification,
                   scan-context descriptors
    registration/  NDT registration (kernel path: frozen-bin terms + LM;
                   sparse path: 27-neighbour Gaussians by binary search),
                   brute-force ICP (one pair or a batch), raster-tier
                   pair ICP and the size-routed icp_auto, k-NN normals,
                   robust weights
    mapping/       dense moment window (insert, scroll, NDT field,
                   occupancy layer, coarsening), the sparse voxel map
                   (insert and incremental merge, eviction, normals, host
                   bulk build, coarsening) and its occupancy grid
    kernels/       voxel hashing, downsampling, and the hand-written CUDA
                   kernels with their plain versions: NDT terms
                   (csrc/ndt_terms.cu), brute-force NN (csrc/nn_search.cu),
                   ICP terms (csrc/icp_terms.cu), row gathers
                   (csrc/gather.cu), built with nvcc at first use
    benchmarks/    the gather probes on the gather kernels
    ingest/        the CoLa-A telegram code and the native runtime's
                   binding (native/src built with g++ at first use), the
                   unit's frame chain, the scan aggregator, the extrinsic
                   calibration (twiddle, annealing, autograd + Adam),
                   synthetic worlds, routes, the line scanner, the rotating
                   capture and the VLP-16 simulator, deskew, VLP-16 packets
                   and pcap, rosbag, npz datasets
    core/          SE(3) and quaternions (batched), symmetric 3x3 closed
                   forms, padded point clouds, the deterministic
                   scatter-add, constant tensors made once per device
    utils/         timing on the card (slope_time, call_ms), tracing
                   (torch.profiler), structured logging, the PLY writer,
                   the CUDA-graph capture of the compiled programs (the
                   dense engine's step, the pose-graph solve,
                   ndt_register, JitLidarOdometry's step, icp_raster,
                   the batched icp, the map insert, the keyframe store,
                   the scan line, the after-loop map and window rebuilds,
                   sc_distance, and the host engine's coarsen_map,
                   occupancy maintenance and deskew)

Entry points run on the GPU unless the caller passes ``device="cpu"``; a
missing GPU raises instead of silently falling back.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"

# Full float32 everywhere. On Hopper a float32 matmul may otherwise go
# through TF32 (10-bit mantissa): the reference's bf16 matmul passes decayed
# the rotation determinant to 0.81 in 80 scans, and every product in this
# engine has a tiny contraction dimension, so full precision costs nothing.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


def default_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else CUDA.

    Raises RuntimeError when no device was asked for and CUDA is absent —
    the engine never carries on quietly on the CPU.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "tpu_slam_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    return torch.device("cuda")
