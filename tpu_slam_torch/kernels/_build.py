"""Build the CUDA sources under ``tpu_slam_torch/csrc`` with nvcc, load them
with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C launch function, so the build is
one ``nvcc -shared`` call of a few seconds (no PyTorch headers). Libraries go
to ``tpu_slam_torch/_build/`` under a name that carries the hash of the
source, of every header in ``csrc`` and of the ``-D`` defines it was built
with, so an edited source or header is rebuilt and an unchanged one is
loaded as is.

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
from typing import Dict, Mapping, Optional, Sequence, Tuple

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


def _define_flags(defines: Optional[Mapping[str, object]]
                  ) -> Tuple[str, ...]:
    return tuple(f"-D{k}={v}" for k, v in sorted((defines or {}).items()))


def library_path(name: str, defines: Optional[Mapping[str, object]] = None
                 ) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(_define_flags(defines)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str, defines: Optional[Mapping[str, object]] = None
          ) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` for each of ``defines``)
    unless its library exists; returns the path.

    The compiler's resource report (``-Xptxas -v``) is written beside the
    library as ``<lib>.ptxas.txt``.
    """
    out = library_path(name, defines)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, *_define_flags(defines), "-o", tmp,
             str(CSRC / f"{name}.cu")],
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
