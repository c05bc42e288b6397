"""nvcc build of sv3d_tpu_torch/csrc/*.cu into one shared library with a
plain C interface, loaded with ctypes.

The library is built at first use into ``build/sv3d_tpu_torch/`` at the
checkout root, under a name keyed by a hash of the sources and flags, and is
renamed into place atomically (as sv3d_tpu/native/Makefile does), so a
concurrent loader never opens a half-written file and a stale build is never
reused.  Each source compiles in its own nvcc process, all started together,
and one more nvcc links the objects.  Building with nvcc alone takes seconds;
a source that includes PyTorch's headers would take minutes, so the C entries
take raw pointers.  Each compile runs with ``-Xptxas -v``, and what ptxas
says of every kernel (registers, shared memory, spills) is kept beside the
library.

    python -m sv3d_tpu_torch.ops.cuda.build --report

builds if needed and prints that report.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "sv3d_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
COMPILE_FLAGS = ("-Xptxas", "-v")  # the per-source compiles: ptxas's resource report


def _sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
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


def report_path() -> Path:
    """Where ptxas's resource report of the current library lives."""
    lib = library_path()
    return lib.with_name(f"{lib.stem}.ptxas.txt")


def build() -> Path:
    """Compile the kernels if this source hash has no library yet; raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists() and report_path().exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"tmp.{os.getpid()}"
    tmp = lib.with_name(f"{lib.name}.{tag}")
    tmp_report = report_path().with_name(f"{report_path().name}.{tag}")
    objs = [lib.with_name(f"{lib.stem}.{src.stem}.{tag}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(_sources(), objs)]
    cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *(str(o) for o in objs)])
    try:
        outs = _run_all(cmds[:-1])  # one nvcc per source, all at once
        _run_all(cmds[-1:])  # the link
        tmp_report.write_text("\n".join(f"== {src.name}\n{out}"
                                         for src, out in zip(_sources(), outs)))
        os.replace(tmp_report, report_path())
        os.replace(tmp, lib)
    finally:
        for f in [*objs, tmp, tmp_report]:
            f.unlink(missing_ok=True)
    return lib


def _run_all(cmds) -> list:
    """Run the commands in parallel, wait for all; raise with the output of
    the ones that failed.  Returns each command's output (stdout, then
    stderr)."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    outs = [p.communicate() for p in procs]
    failed = [
        f"nvcc failed (exit {p.returncode}):\n{' '.join(cmd)}\n{out}\n{err}"
        for cmd, p, (out, err) in zip(cmds, procs, outs) if p.returncode != 0
    ]
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out + err for out, err in outs]


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    return ctypes.CDLL(str(build()))


def check(rc: int, name: str) -> None:
    """Raise when a C entry returned a CUDA error (its cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def report() -> str:
    """ptxas's resource report (registers, shared memory, spills) of every
    kernel of the current library, built if needed."""
    build()
    return report_path().read_text()


def resources(part: str, text: str | None = None) -> dict:
    """{mangled kernel name: (registers, spill store bytes, spill load
    bytes)} of the kernels whose name holds part, from report()'s text (or
    the given text)."""
    text = report() if text is None else text
    out, name, spills = {}, None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None and part in name:
            out[name] = (int(m.group(1)), *spills)
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["--report"]:
        print(report())
    else:
        print(build())
