"""Ring-rotation hammings (`hammings -R`): each device holds one genome
block.

Port of kit4b_tpu/parallel/hammings_ring.py. `hammings_mesh` replicates
the whole partner one-hot on every device; here device i of D holds only
block i of the raw codes of both strands ([B + K] with a K halo from the
next block), builds its own rows' one-hot once, and the partner code
blocks rotate around the ring (`mesh.ppermute`, JAX's permutation: after
step s device i holds block (i + s) % D). Every step rebuilds the partner
one-hot on the device and runs the same `kernels.minmm` as the replicated
engine, keeping the running minimum. The self pair exists only at step 0,
where the partner block is the own block and the local diagonal is the
global one: step 0 runs diag on the sense strand, the D - 1 rotated steps
run without it. Window validity is computed on the host, as JAX does.
"""
from __future__ import annotations

import numpy as np
import torch

from ..dna import BASE_EOG
from ..kernels.minmm import minmm
from ..kmer.hammings_mxu import OUT_BIG, _round_up, build_w
from .mesh import Mesh, default_devices, ppermute


def _block_onehot(codes: torch.Tensor, K: int, B: int):
    """(W [B, C] int8 with invalid windows zeroed, valid [B] bool) of one
    code block: codes [B + K], the own block plus K halo codes. A window is
    valid when it holds no sentinel (code >= 5), so this is `build_w` with
    its start bound G - K + 1 set past the block."""
    return build_w(codes, K=K, Gp=B, G=B + K - 1, rc=False)


def make_hammings_ring(mesh: Mesh, G: int, K: int, *,
                       antisense: bool = True, T: int = 1024,
                       S: int = 1024):
    """The ring engine over the "sp" axis of `mesh`: returns (fn, B),
    fn(sense_blocks, rc_blocks) taking [D, B + K] uint8 code blocks (see
    `hammings_ring`) and returning hmin [D*B] int32 before the validity
    mask."""
    devices = list(mesh.devices.flat)
    D = len(devices)
    B = _round_up(-(-max(G, 1) // D), max(T, S))

    def pair_min(Wo, codes_pair, diag: bool):
        """min-Hamming of own rows against both strands of a partner code
        block; diag applies to the sense strand only (a reverse-complement
        window never aliases an own window)."""
        parts = [(_block_onehot(codes_pair[0], K, B)[0], diag)]
        if antisense:
            parts.append((_block_onehot(codes_pair[1], K, B)[0], False))
        maxm = None
        for W_part, dg in parts:
            m = minmm(Wo, W_part, diag=dg, span_lo=0, span_cnt=B // S, S=S,
                      row_base=0)
            maxm = m if maxm is None else torch.maximum(maxm, m)
        return K - maxm

    def fn(sense_blocks: np.ndarray, rc_blocks: np.ndarray) -> np.ndarray:
        cps = [torch.from_numpy(np.stack([sense_blocks[i], rc_blocks[i]]))
               .to(dev) for i, dev in enumerate(devices)]
        Wos = [_block_onehot(cp[0], K, B)[0] for cp in cps]
        # step 0: the partner block is the own block
        hs = [pair_min(Wo, cp, diag=True) for Wo, cp in zip(Wos, cps)]
        for _ in range(D - 1):
            cps = ppermute(cps, devices)
            hs = [torch.minimum(h, pair_min(Wo, cp, diag=False))
                  for h, Wo, cp in zip(hs, Wos, cps)]
        return np.concatenate([h.cpu().numpy() for h in hs])
    return fn, B


def hammings_ring(genome_seq: np.ndarray, K: int, *,
                  antisense: bool = True, devices=None,
                  T: int = 1024, S: int = 1024) -> np.ndarray:
    """Ring-parallel exhaustive hammings over `devices` (default: every
    visible CUDA device); the output contract of
    `kmer.hammings_mxu.hammings_exhaustive_mxu` (uint16 [G])."""
    mesh = Mesh(list(devices) if devices is not None else default_devices(),
                ("sp",))
    D = mesh.devices.size
    g = np.ascontiguousarray(genome_seq, np.uint8)
    G = len(g)
    out = np.full(G, OUT_BIG, np.uint16)
    if G - K + 1 <= 0:
        return out
    B = _round_up(-(-G // D), max(T, S))
    Gp = B * D

    ext = np.concatenate([g, np.full(Gp + K - G, BASE_EOG, np.uint8)])
    rcg = np.where(g < 4, 3 - g, g)[::-1]
    rc_ext = np.concatenate([rcg, np.full(Gp + K - G, BASE_EOG, np.uint8)])
    sense_blocks = np.stack([ext[i * B: i * B + B + K] for i in range(D)])
    rc_blocks = np.stack([rc_ext[i * B: i * B + B + K] for i in range(D)])

    # validity (host): no sentinel in the window, and a start before
    # G - K + 1, as the replicated engine's `valid`
    sent = (ext[:Gp + K] >= 5).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(sent)])
    nbad = cs[K: Gp + K] - cs[:Gp]
    valid = (nbad == 0) & (np.arange(Gp) < G - K + 1)
    nvalid = int(valid.sum())
    if nvalid == 0 or (not antisense and nvalid < 2):
        return out

    fn, B = make_hammings_ring(mesh, G, K, antisense=antisense, T=T, S=S)
    hmin = fn(sense_blocks, rc_blocks)
    h = np.where(valid[:G], np.minimum(hmin[:G], int(OUT_BIG)),
                 int(OUT_BIG))
    return h.astype(np.uint16)
