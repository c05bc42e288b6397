"""nvcc build of sv3d_tpu_torch/csrc/*.cu into one shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into ``build/sv3d_tpu_torch/`` at the
checkout root, under a name keyed by a hash of the sources and flags, and is
renamed into place atomically (as sv3d_tpu/native/Makefile does), so a
concurrent loader never opens a half-written file and a stale build is never
reused.  Building with nvcc alone takes seconds; a source that includes
PyTorch's headers would take minutes, so the C entries take raw pointers.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sv3d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsv3d_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(s) for s in _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    return ctypes.CDLL(str(build()))


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
