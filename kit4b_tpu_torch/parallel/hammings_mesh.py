"""Mesh-parallel hammings (`hammings -M`): own-row sharding of the
max-match engine; port of kit4b_tpu/parallel/hammings_mesh.py.

Device i of D takes own rows [i*R, (i+1)*R) of the padded genome, R =
Gp / D, against the node's partner spans at their global row bases, so
the self pair is masked where it falls. A shard is the node engine
(`kmer/hammings_mxu.py` `HammingsNode`) at T' = D*T, whose Gp is the
mesh's, G rounded up to max(D*T, S), as in JAX: one node a distinct
device holds the codes and the node's partner windows, and streams the
shard's rows in blocks. The plain engine rounds to max(T, S) with T =
2048, so with `-n` > 1 a node's file can differ from the plain engine's,
in JAX as well; the merge over every node, and any run with `-n 1`, agree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kmer.hammings_mxu import OUT_BIG, HammingsNode
from .mesh import default_devices


def shard_rows(g: np.ndarray, K: int, devices: list, *, antisense: bool,
               node: int, numnodes: int, T: int, S: int) -> np.ndarray:
    """uint16 [Gp] distances of node `node` of `numnodes` of the node
    engine at (T, S), its own rows cut into D = len(devices) equal shards,
    shard i on devices[i]; one `HammingsNode` a distinct device."""
    engines: dict = {}
    parts = []
    for i, dev in enumerate(map(torch.device, devices)):
        if dev not in engines:
            engines[dev] = HammingsNode(g, K, antisense=antisense, node=node,
                                        numnodes=numnodes, T=T, S=S,
                                        device=dev)
        eng = engines[dev]
        R = eng.Gp // len(devices)
        parts.append(eng.rows_in_blocks(i * R, (i + 1) * R))
    return np.concatenate(parts)


def hammings_mesh(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None,
                  node: int = 0, numnodes: int = 1,
                  T: int = 1024, S: int = 1024) -> np.ndarray:
    """The row-sharded engine over `devices` (default: every visible CUDA
    device; `[torch.device("cpu")] * D` runs D shards here); the output
    contract of `kmer.hammings.hammings_exhaustive` (uint16 [G], 0xFFFF
    where no valid window)."""
    devices = list(devices) if devices is not None else default_devices()
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    out = np.full(G, OUT_BIG, np.uint16)
    if G < K:
        return out
    h = shard_rows(g, K, devices, antisense=antisense, node=node,
                   numnodes=numnodes, T=len(devices) * T, S=S)[:G]
    nvalid = int((h != int(OUT_BIG)).sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        return out
    return h
