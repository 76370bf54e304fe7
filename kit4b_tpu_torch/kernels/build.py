"""Builds the port's CUDA kernels from `csrc/` at first use.

Each kernel source `csrc/<name>.cu` has a plain C interface. `load(name)`
compiles it with nvcc for Hopper (sm_90a) into
`_build/lib<name>-<key>.so`, where the key is a hash of the source and the
flags, and loads it with ctypes. A library that is already built for the
same key is loaded as it is, so a process builds each kernel once and a
changed source builds anew. nvcc's output, with ptxas's register and
shared-memory report, is kept beside the library in a `.log` file.

A failed build raises: there is no fallback to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def paths(name: str) -> tuple[Path, Path, Path]:
    """(source, library, build log) of kernel `name`."""
    src = CSRC / f"{name}.cu"
    key = hashlib.sha256(src.read_bytes()
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    stem = BUILD / f"lib{name}-{key}"
    return src, stem.with_suffix(".so"), stem.with_suffix(".log")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME")


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of `csrc/<name>.cu`."""
    src, lib, log = paths(name)
    if not lib.exists():
        BUILD.mkdir(exist_ok=True)
        tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.so")
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                           capture_output=True, text=True)
        log.write_text(r.stdout + r.stderr)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed to build {src.name} "
                               f"(exit {r.returncode}):\n{r.stderr[-4000:]}")
        os.replace(tmp, lib)   # atomic: concurrent builders never see half a file
    return ctypes.CDLL(str(lib))
