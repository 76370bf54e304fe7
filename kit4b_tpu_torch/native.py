"""The host library of the kalign path: `native/libkit4b_native.so`.

The port binds the two symbols its kalign path calls, `pack2bit_u8` (2-bit
read packing) and `format_sam_se` (the bulk SAM formatter), on a ctypes
handle of its own and declares each signature here, symbol by symbol. A
library that lacks one of them, or cannot be built, raises
`NativeUnavailable`: the path has no numpy or per-read fallback.

The library is built from `native/` with make at first use by the JAX
package's loader (`kit4b_tpu.index.sa_build._load_native`, which imports
no jax), as the suffix-array build of the shared index already needs it.
"""
from __future__ import annotations

import ctypes
import functools

from kit4b_tpu.index import sa_build

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

SIGNATURES = {
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
    """The host library cannot be built or lacks a symbol the path needs."""


@functools.lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    """The library with the signatures of SIGNATURES declared."""
    if sa_build._load_native() is None:
        raise NativeUnavailable(
            f"{sa_build._LIB_PATH} is missing and `make -C native` failed; "
            "the kalign path needs a C++ compiler to build it")
    lib = ctypes.CDLL(sa_build._LIB_PATH)
    for name, (restype, argtypes) in SIGNATURES.items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            raise NativeUnavailable(
                f"{sa_build._LIB_PATH} has no symbol {name}; rebuild it "
                "with `make -C native clean all`") from None
        fn.restype = restype
        fn.argtypes = argtypes
    return lib
