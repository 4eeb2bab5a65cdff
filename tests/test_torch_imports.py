"""tpu_slam_torch stands alone: no JAX, no tpu_slam, none of the repo's
benchmarks/ package, the GPU by default."""

import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
import tpu_slam_torch
names = ["tpu_slam_torch"] + [
    m.name for m in pkgutil.walk_packages(tpu_slam_torch.__path__,
                                          "tpu_slam_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "tpu_slam" or m.startswith("tpu_slam.")
             or m == "benchmarks" or m.startswith("benchmarks."))
print(len(names), bad)
print(" ".join(names))
"""

# modules whose absence would leave a slice's path unchecked: the CLIs,
# the replay, deskew and live-chain ingest, the sparse voxel map, the live
# pipeline, the calibration, the distributed layer, logging and tracing
NEW_MODULES = ("tpu_slam_torch.cli.run_odometry", "tpu_slam_torch.cli.common",
               "tpu_slam_torch.ingest.deskew", "tpu_slam_torch.ingest.velodyne",
               "tpu_slam_torch.ingest.rosbag", "tpu_slam_torch.ingest.dataset",
               "tpu_slam_torch.mapping.voxel_map",
               "tpu_slam_torch.ingest.sick_cola", "tpu_slam_torch.ingest.native",
               "tpu_slam_torch.ingest.frames",
               "tpu_slam_torch.ingest.aggregator",
               "tpu_slam_torch.ingest.calibration",
               "tpu_slam_torch.pipeline.live", "tpu_slam_torch.utils.ply",
               "tpu_slam_torch.cli.run_live", "tpu_slam_torch.cli.run_slam",
               "tpu_slam_torch.cli.run_calibration",
               "tpu_slam_torch.cli.make_dataset",
               "tpu_slam_torch.cli.pcap_convert",
               "tpu_slam_torch.distributed",
               "tpu_slam_torch.distributed.mesh",
               "tpu_slam_torch.distributed.multihost",
               "tpu_slam_torch.distributed.registration_dist",
               "tpu_slam_torch.distributed.pose_graph_dist",
               "tpu_slam_torch.distributed.schur",
               "tpu_slam_torch.distributed.map_shard",
               "tpu_slam_torch.distributed.dense_shard",
               "tpu_slam_torch.utils.logging",
               "tpu_slam_torch.utils.tracing")


def test_port_and_chip_smoke_import_neither_jax_nor_tpu_slam():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    head, listed = out.stdout.strip().splitlines()
    n, bad = head.split(" ", 1)
    assert int(n) >= 20          # every module of the package was imported
    assert bad == "[]"
    assert set(NEW_MODULES) <= set(listed.split())


def test_engine_raises_without_cuda_unless_cpu_is_asked(monkeypatch):
    from tpu_slam_torch import default_device
    from tpu_slam_torch.pipeline.config import OdometryConfig
    from tpu_slam_torch.pipeline.odometry_dense import DenseLidarOdometry
    from tpu_slam_torch.registration.ndt import NDTParams

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = OdometryConfig(ndt=NDTParams(window_dims=(16, 16, 8)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DenseLidarOdometry(cfg)
    with pytest.raises(RuntimeError):
        default_device()
    assert DenseLidarOdometry(cfg, device="cpu").device.type == "cpu"


def test_precision_is_full_float32():
    import tpu_slam_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
