"""Builds the port's CUDA kernels from `csrc/` at first use.

Each kernel source `csrc/<name>.cu` has a plain C interface. `load(name)`
compiles it with nvcc for Hopper (sm_90a) into
`_build/lib<name>-<key>.so`, where the key is a hash of the source and the
flags, and loads it with ctypes. A library that is already built for the
same key is loaded as it is, so a process builds each kernel once and a
changed source builds anew. `build(*names)` compiles several kernels at
once, one nvcc process each. nvcc's output, with ptxas's register and
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


def build(*names: str) -> None:
    """Build every named kernel whose library is missing: one nvcc each,
    all started together."""
    jobs = []
    for name in names:
        src, lib, log = paths(name)
        if lib.exists():
            continue
        BUILD.mkdir(exist_ok=True)
        tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.so")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        jobs.append((src, lib, log, tmp, proc))
    failed = []
    for src, lib, log, tmp, proc in jobs:
        out, err = proc.communicate()
        log.write_text(out + err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed to build {src.name} "
                          f"(exit {proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, lib)   # atomic: a concurrent process never sees half a file
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of `csrc/<name>.cu`."""
    build(name)
    return ctypes.CDLL(str(paths(name)[1]))
