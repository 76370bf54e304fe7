"""Mesh-parallel hammings (`hammings -M`): own-row sharding of the
max-match engine.

Port of kit4b_tpu/parallel/hammings_mesh.py. The window one-hot matrix W
(and its reverse complement's, Wrc) is replicated; device i of D takes own
rows [i*R, (i+1)*R) of the padded genome, R = Gp / D, and runs
`kernels.minmm` against every partner span of the node's range with its
global row base, so the self pair is masked where it falls. The row blocks
concatenate back; nothing else crosses devices. Node partitioning
(`-n`/`-N`) splits the partner spans, and node results merge with an
elementwise min.

The geometry is JAX's: T = 1024, S = 1024 and Gp = Gp rounded up to
max(D*T, S), and the node's spans come from that Gp. The single-device
engine (`kmer/hammings_mxu.py`) rounds to max(T, S) with T = 2048, so with
`-n` > 1 a node's file can differ from the plain engine's node file, in
JAX as well; the merge over every node, and any run with `-n 1`, agree.
A device's rows go through in one launch a strand, as the single-device
engine's do.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dna import BASE_EOG
from ..kernels.minmm import minmm
from ..kmer.hammings_mxu import OUT_BIG, _round_up, build_w
from .mesh import Mesh, default_devices


def make_hammings_mesh(mesh: Mesh, G: int, K: int, *, antisense: bool = True,
                       T: int = 1024, S: int = 1024, span_lo: int = 0,
                       span_cnt: int | None = None):
    """The sharded engine over the "sp" axis of `mesh`: returns (fn, Gp),
    fn(ext) taking the genome's uint8 codes padded with EOG to Gp + K and
    returning hmin [Gp] int32 (OUT_BIG where a window is invalid)."""
    devices = list(mesh.devices.flat)
    D = len(devices)
    Gp = _round_up(G, max(D * T, S))
    R = Gp // D
    cnt = Gp // S if span_cnt is None else span_cnt

    def fn(ext: np.ndarray) -> np.ndarray:
        out = np.empty(Gp, np.int32)
        held = {}          # W (and Wrc) once a device: they are replicated
        for i, dev in enumerate(devices):
            if dev not in held:
                held.clear()
                e = torch.from_numpy(np.ascontiguousarray(ext)).to(dev)
                W, valid = build_w(e, K=K, Gp=Gp, G=G, rc=False)
                parts = [(W, True)]
                if antisense:
                    parts.append((build_w(e, K=K, Gp=Gp, G=G, rc=True)[0],
                                  False))
                held[dev] = (W, parts, valid)
            W, parts, valid = held[dev]
            r0 = i * R
            maxm = None
            for W_part, diag in parts:
                m = minmm(W[r0:r0 + R], W_part, diag=diag, span_lo=span_lo,
                          span_cnt=cnt, S=S, row_base=r0)
                maxm = m if maxm is None else torch.maximum(maxm, m)
            h = torch.where(valid[r0:r0 + R],
                            (K - maxm).clamp(max=int(OUT_BIG)), int(OUT_BIG))
            out[r0:r0 + R] = h.cpu().numpy()
        return out
    return fn, Gp


def hammings_mesh(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None,
                  node: int = 0, numnodes: int = 1,
                  T: int = 1024, S: int = 1024) -> np.ndarray:
    """The row-sharded engine over `devices` (default: every visible CUDA
    device; `[torch.device("cpu")] * D` runs D shards here); the output
    contract of `kmer.hammings.hammings_exhaustive` (uint16 [G], 0xFFFF
    where no valid window)."""
    mesh = Mesh(list(devices) if devices is not None else default_devices(),
                ("sp",))
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    out = np.full(G, OUT_BIG, np.uint16)
    if G < K:
        return out[:0] if G == 0 else out
    D = mesh.devices.size
    Gp = _round_up(G, max(D * T, S))
    n_spans = Gp // S
    lo = (node * n_spans) // numnodes
    hi = ((node + 1) * n_spans) // numnodes
    if hi <= lo:
        return out
    fn, Gp = make_hammings_mesh(mesh, G, K, antisense=antisense, T=T, S=S,
                                span_lo=lo, span_cnt=hi - lo)
    ext = np.concatenate([g, np.full(Gp + K - G, BASE_EOG, np.uint8)])
    h = fn(ext)[:G]
    nvalid = int((h != int(OUT_BIG)).sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        return out
    return h.astype(np.uint16)
