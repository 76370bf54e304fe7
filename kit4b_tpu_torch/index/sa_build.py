"""Host-side suffix-array construction, the port's own copy of
kit4b_tpu/index/sa_build.py on the port's host library.

SA-IS (O(n), native/sais.cpp) through `native.load()`. The JAX package
falls back to numpy prefix doubling without its library; the port does not:
a missing library raises `NativeUnavailable`.

Replaces the reference's multithreaded comparison quicksort
(libkit4b/SfxArray.cpp:9739 QSortSeq + MTqsort); the sorted order is unique,
so outputs are interchangeable.
"""
from __future__ import annotations

import ctypes

import numpy as np

from .. import native


def build_suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of a uint8 text. int32 when n < 2^31 - 1, else int64."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    n = len(text)
    lib = native.load()
    if n < 2**31 - 1:
        sa = np.empty(n, dtype=np.int32)
        rc = lib.sais_u8_i32(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n)
    else:
        sa = np.empty(n, dtype=np.int64)
        rc = lib.sais_u8_i64(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n)
    if rc != 0:
        raise RuntimeError(f"native sais failed with code {rc}")
    return sa
