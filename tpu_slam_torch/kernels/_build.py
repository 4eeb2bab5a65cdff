"""Build the CUDA sources under ``tpu_slam_torch/csrc`` with nvcc, load them
with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function, so the build is
one ``nvcc -shared`` call of a few seconds (no PyTorch headers). Libraries go
to ``tpu_slam_torch/_build/`` under a name that carries the source's hash,
so an edited source is rebuilt and an unchanged one is loaded as is.

``bind`` and ``launch`` are the lean launch path of the kernel wrappers: a
launch function is bound once per process, and a launch reads the current
stream's raw handle (never cached: a caller may switch streams) and enters
a device guard only when the tensors' device is not the current one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Sequence

import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of tpu_slam_torch "
                       "are built from source at first use")


def library_path(name: str) -> pathlib.Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(name: str) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the path.

    The compiler's resource report (``-Xptxas -v``) is written beside the
    library as ``<lib>.ptxas.txt``.
    """
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        out.with_suffix(".ptxas.txt").write_text(proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes: Sequence,
         restype=ctypes.c_int):
    """The ctypes function ``symbol`` of ``csrc/<name>.cu``, its argument
    and result types set (pointers and the stream as ``c_void_p``)."""
    fn = getattr(load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def launch(what: str, fn, device_index: int, *args) -> None:
    """``fn(*args, stream)`` on the current stream of CUDA device
    ``device_index``; raises RuntimeError if it returns a CUDA error."""
    c = torch._C
    if c._cuda_getDevice() == device_index:
        rc = fn(*args, c._cuda_getCurrentRawStream(device_index))
    else:
        with torch.cuda.device(device_index):
            rc = fn(*args, c._cuda_getCurrentRawStream(device_index))
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")
