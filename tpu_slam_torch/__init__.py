"""tpu_slam_torch — the dense-window LiDAR SLAM engine in PyTorch + CUDA.

A port of the JAX package ``tpu_slam`` to PyTorch on an NVIDIA H100. Module
paths and public names follow ``tpu_slam`` so each function's counterpart is
easy to find; the JAX package stays the reference and this package imports
nothing of it (nor of JAX).

Layer map of what is ported so far (full SLAM on the dense odometry
engine, pair ICP on both tiers, the gather probes):

    pipeline/      SLAMSystem (keyframes, loop sweeps, graph, re-anchor),
                   DenseLidarOdometry, config, metrics, state hand-over,
                   checkpoint/resume
    graph/         pose graph (GN + matrix-free PCG), loop-closure
                   candidates and batched symmetric ICP verification,
                   scan-context descriptors
    registration/  NDT registration (kernel path: frozen-bin terms + LM),
                   brute-force ICP (one pair or a batch), raster-tier
                   pair ICP and the size-routed icp_auto, k-NN normals,
                   robust weights
    mapping/       dense moment window (insert, scroll, NDT field)
    kernels/       voxel hashing, downsampling, and the hand-written CUDA
                   kernels with their plain versions: NDT terms
                   (csrc/ndt_terms.cu), brute-force NN (csrc/nn_search.cu),
                   ICP terms (csrc/icp_terms.cu), row gathers
                   (csrc/gather.cu), built with nvcc at first use
    benchmarks/    the gather probes on the gather kernels
    ingest/        synthetic worlds, routes and the VLP-16 simulator
    core/          SE(3) (batched), symmetric 3x3 closed forms, padded
                   point clouds, the deterministic scatter-add
    utils/         timing on the card (slope_time, call_ms)

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
