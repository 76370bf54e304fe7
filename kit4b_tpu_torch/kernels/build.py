"""Builds the port's CUDA kernels from `csrc/` at first use.

Each kernel source `csrc/<name>.cu` has a plain C interface. `load(name)`
compiles it with nvcc for Hopper (sm_90a) into
`_build/lib<name>-<key>.so`, where the key is a hash of the source, the
headers of `csrc/` (`*.cuh`, which the sources include) and the flags, and
loads it with ctypes. A library that is already built for the same key is
loaded as it is, so a process builds each kernel once and a changed source
or header builds anew. `build(*names)` compiles several kernels at
once, one nvcc process each. nvcc's output, with ptxas's register and
shared-memory report, is kept beside the library in a `.log` file.

`source_key` and `compile_libs` hold the keying and the atomic build for
every library the port compiles; `native.py` builds the host library
through them too.

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


def source_key(sources, flags) -> str:
    """16 hex digits of the SHA-256 of the flags and the sources' bytes.
    Raises OSError when a source is missing."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(Path(src).read_bytes())
    return h.hexdigest()[:16]


def compile_libs(jobs) -> list[str]:
    """Compile each job `(argv, sources, library)` as `argv -o <tmp>
    sources`: one process each, all started together. A job's library is
    written under a temporary name made from the pid and moved into place
    only when its build succeeds, so a concurrent process never sees half a
    file; the compiler's output goes into a `.log` beside the library.
    Returns one message for each build that failed."""
    running = []
    for argv, sources, lib in jobs:
        lib.parent.mkdir(exist_ok=True)
        tmp = lib.with_name(f".{lib.stem}.{os.getpid()}.so")
        proc = subprocess.Popen([*argv, "-o", str(tmp), *map(str, sources)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        running.append((Path(argv[0]).name, lib, tmp, proc))
    failed = []
    for cc, lib, tmp, proc in running:
        out, err = proc.communicate()
        lib.with_suffix(".log").write_text(out + err)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{cc} failed to build {lib.name} "
                          f"(exit {proc.returncode}):\n{err[-4000:]}")
        else:
            os.replace(tmp, lib)
    return failed


def paths(name: str) -> tuple[Path, Path, Path]:
    """(source, library, build log) of kernel `name`; the key covers the
    headers of `csrc/` too."""
    src = CSRC / f"{name}.cu"
    headers = sorted(CSRC.glob("*.cuh"))
    stem = BUILD / f"lib{name}-{source_key([src, *headers], NVCC_FLAGS)}"
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
        src, lib, _ = paths(name)
        if not lib.exists():
            jobs.append(([_nvcc(), *NVCC_FLAGS], [src], lib))
    failed = compile_libs(jobs)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the shared library of `csrc/<name>.cu`."""
    build(name)
    return ctypes.CDLL(str(paths(name)[1]))
