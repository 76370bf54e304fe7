"""2-bit genome packing for the extension passes (host numpy).

Re-homed from kit4b_tpu/ops/extend_packed.py, which imports jax at module
top; held byte-identical to it by tests/test_torch_kalign_host.py.
"""
from __future__ import annotations

import numpy as np


def pack_genome(seq: np.ndarray, nw: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack genome codes -> (gpack, gbad) uint32 arrays, padded by nw words.

    gpack: base i in bits [2*(i%16)] of word i//16 (low 2 bits of the code).
    gbad : bit 2*(i%16) set when base i is invalid (N/sentinel/beyond end).
    """
    g = np.asarray(seq, dtype=np.uint8)
    n = len(g)
    nwords = (n + 15) // 16 + nw
    base = np.zeros(nwords * 16, dtype=np.uint32)
    bad = np.ones(nwords * 16, dtype=np.uint32)  # off-end slots are invalid
    base[:n] = g & 3
    bad[:n] = g >= 4
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    gpack = (base.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
    gbad = (bad.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)
    return gpack, gbad
