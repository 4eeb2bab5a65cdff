"""The import guard and the refusal of a run without a card."""

import json
import os
import shutil
import subprocess
import sys

from slambench.run import forbidden_modules
from slambench.tests.tiny_cells import REPO


def test_guard_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "numpy"]) == ["jax",
                                                               "jax.numpy"]
    assert forbidden_modules(["tpu_slam.pipeline"]) == ["tpu_slam.pipeline"]
    assert forbidden_modules(["jaxlib.xla_client", "flax"]) == [
        "flax", "jaxlib.xla_client"]
    assert forbidden_modules(["tpu_slam_torch", "tpu_slam_torch.core",
                              "jaxtyping", "slambench.run"]) == []


def test_harness_and_reference_load_nothing_forbidden():
    code = ("import sys, slambench.run, slambench.world, "
            "slambench.systems.dense_odometry, slambench.systems.slam, "
            "slambench.reference.odometry, slambench.reference.sweep, "
            "slambench.control, slambench.trace; "
            "print([m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'tpu_slam')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, slambench.reference.odometry, "
            "slambench.reference.sweep; "
            "print([m for m in sys.modules if m.startswith('tpu_slam')])")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "-m", "slambench.run", "--workload", "c2-city-laps",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr
    for line in out.stdout.splitlines():
        assert "memory_peak_bytes" not in json.loads(line)


def test_run_fails_where_only_the_benchmark_is_present(tmp_path):
    """A checkout of BENCHMARK.json and slambench/ alone has no program:
    the run stops at the import of the port, whatever the device."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "slambench", tmp_path / "slambench")
    code = ("from slambench.run import run_cell; "
            "print(run_cell('.', 'c2-city-laps', 7, 1.0, False, "
            "device='cpu'))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, env=env)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "tpu_slam_torch" in out.stderr
