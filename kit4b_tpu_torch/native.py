"""The port's host library, built from `native/sais.cpp` and
`native/hostops.cpp`.

Through `kernels/build.py`'s keyed build, `load()` compiles the two C++ sources with g++
and the flags of `native/Makefile` at first use into
`_build/libkit4b_native-<key>.so`, where the key is a hash of the sources,
the flags and what `-march=native` resolves to on this CPU (`cpu_identity`),
and loads it with ctypes. A library already built for the same key is
loaded as it is; a changed source builds anew, so a stale library never
reaches the port, and a `_build/` carried to a host with another CPU builds
anew instead of loading code that CPU may not run. Nothing is written into
`native/`.

Every symbol the port calls is declared in SIGNATURES, one by one: the
SA-IS and counting-sort builds of the index (`sais_u8_i32`, `sais_u8_i64`,
`bucket_index`), and the 2-bit read packing and bulk SAM formatter of the
kalign path (`pack2bit_u8`, `format_sam_se`). A missing compiler or
source, a failed build or a missing symbol raises `NativeUnavailable`:
neither path has a numpy fallback.
"""
from __future__ import annotations

import ctypes
import functools
import shutil
import subprocess
from pathlib import Path

from .kernels.build import compile_libs, source_key

PKG = Path(__file__).resolve().parent
SOURCES = tuple(PKG.parent / "native" / n for n in ("sais.cpp", "hostops.cpp"))
BUILD = PKG / "_build"
# the flags of native/Makefile
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

SIGNATURES = {
    # (text, suffix array out, n) -> 0 on success
    "sais_u8_i32": (ctypes.c_int, [_u8p, _i32p, ctypes.c_int64]),
    "sais_u8_i64": (ctypes.c_int, [_u8p, _i64p, ctypes.c_int64]),
    # (seq, n, k, positions out, lut out) -> clean positions written, or -1
    # outside 1 <= k <= 15, k <= n < 2^31
    "bucket_index": (ctypes.c_int64,
                     [_u8p, ctypes.c_int64, ctypes.c_int64, _i32p, _i64p]),
    # (reads, B, L, packed out, nlist out, n_cap) -> N count, or -1 when
    # the batch holds more than n_cap Ns
    "pack2bit_u8": (ctypes.c_int64,
                    [_u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _i32p,
                     ctypes.c_int64]),
    # (qnames, qname offsets, chrom names, chrom offsets, flag, chrom
    # index, 1-based pos, mapq, NM, seq, qual, n, L, out, cap) -> bytes
    # written, or -1 when cap is too small
    "format_sam_se": (ctypes.c_int64,
                      [ctypes.c_char_p, _i64p, ctypes.c_char_p, _i64p,
                       _i32p, _i32p, _i64p, _i32p, _i32p, _u8p, _u8p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p,
                       ctypes.c_int64]),
}


class NativeUnavailable(RuntimeError):
    """The host library cannot be built or lacks a symbol the port needs."""


@functools.lru_cache(maxsize=1)
def cpu_identity() -> str:
    """What `-march=native` resolves to here: g++'s report of the target
    options it enables, or without g++ the `flags` line of /proc/cpuinfo."""
    cxx = shutil.which("g++")
    if cxx is not None:
        out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                             capture_output=True, text=True)
        if out.returncode == 0:
            return out.stdout
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def lib_path() -> Path:
    """The library of the current sources, flags and CPU."""
    try:
        key = source_key(SOURCES, CXXFLAGS + (cpu_identity(),))
    except OSError as e:
        raise NativeUnavailable(f"host library source missing: {e}") from None
    return BUILD / f"libkit4b_native-{key}.so"


def build() -> Path:
    """Build the library if it is missing, and return its path."""
    lib = lib_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++")
    if cxx is None:
        raise NativeUnavailable("g++ not found: the host library needs a C++ "
                                "compiler")
    failed = compile_libs([([cxx, *CXXFLAGS, "-shared"], SOURCES, lib)])
    if failed:
        raise NativeUnavailable(failed[0])
    return lib


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The library, built if needed, with the signatures of SIGNATURES."""
    path = build()
    lib = ctypes.CDLL(str(path))
    for name, (restype, argtypes) in SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise NativeUnavailable(f"{path} has no symbol {name}") from None
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
