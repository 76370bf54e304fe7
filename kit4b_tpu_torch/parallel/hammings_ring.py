"""Ring-parallel hammings (`hammings -R`); port of
kit4b_tpu/parallel/hammings_ring.py, which rotates D genome blocks of B
around the devices so that every own block meets every partner block.
With m = max(T, S), D * round_up(ceil(G/D), m) = round_up(G, D*m), so
partner block j is the span of node j of D of the node engine at T' =
D*m: the result is the elementwise minimum over j of the mesh's shards for node
j. The self pair is masked only in block j = i, where the global row and
column meet; window validity is the node engine's.
"""
from __future__ import annotations

from functools import reduce

import numpy as np

from ..kmer.hammings_mxu import OUT_BIG
from .hammings_mesh import shard_rows
from .mesh import default_devices


def hammings_ring(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None,
                  T: int = 1024, S: int = 1024) -> np.ndarray:
    """Ring-parallel exhaustive hammings over `devices` (default: every
    visible CUDA device); the output contract of
    `kmer.hammings_mxu.hammings_exhaustive_mxu` (uint16 [G])."""
    devices = list(devices) if devices is not None else default_devices()
    D = len(devices)
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    if G - K + 1 <= 0:
        return np.full(G, OUT_BIG, np.uint16)
    return reduce(np.minimum, (
        shard_rows(g, K, devices, antisense=antisense, node=j, numnodes=D,
                   T=D * max(T, S), S=S) for j in range(D)))[:G]
