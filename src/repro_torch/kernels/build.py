"""Build the CUDA sources of ``repro_torch/csrc`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` into ``build/lib<name>-<hash>.so`` beside this package (the hash
covers the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is never served from a stale library), then loaded with
``ctypes``.  Nothing is compiled or loaded
when this module is imported.  ``build_all`` starts one ``nvcc`` per source,
all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "load", "source_path"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("codebook_matmul", "lut_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def source_path(name: str) -> Path:
    return _CSRC / f"{name}.cu"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME); the kernels are built from source")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(source_path(name).read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start nvcc for one source; None when its library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, lib


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, lib = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)


def build_all(names=SOURCES) -> None:
    """Compile every named source that is not built yet, in parallel."""
    jobs = {n: _start(n) for n in names}
    try:
        for n, job in jobs.items():
            _finish(n, job)
    finally:                      # a failed build stops the others
        for job in jobs.values():
            if job is not None and job[0].poll() is None:
                job[0].kill()
                job[0].wait()
                os.unlink(job[1])


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, compiled first if needed."""
    build_all((name,))
    return ctypes.CDLL(str(_lib_path(name)))
