"""Plain reference of single-end kalign: where each read belongs.

For every read it counts the mismatches against every window of the genome
on both strands, by brute force: one-hot reads times one-hot windows, as
plain matrix products in blocks of windows. A base that is N, on either
side, is a mismatch; a window that holds a chromosome separator (a code of
5 or more) is no locus. Then kalign's rule for single ends (ngskit4b
KAligner, defaults -s 5 -r 1 -n 1):

- at most `max_mm` = max(1, int(0.5 + L * subs_per100 / 100)) mismatches
  (5 for 100 bp at -s 5);
- one locus, over both strands, at the least mismatch count, and the next
  best at least `mm_delta` more;
- at most max(L * ns_per100 // 100, ns_per100) Ns in the read.

A read that keeps all three is accepted at that locus and strand with NM
its mismatch count; any other read is unaligned. It imports nothing of the
program and reads only the genome codes and the reads the benchmark made.
"""
from __future__ import annotations

import numpy as np
import torch

SENTINEL = 5       # codes >= 5 separate chromosomes or end the genome


def max_mismatches(L: int, subs_per100: int) -> int:
    return 0 if subs_per100 == 0 else max(1, int(0.5 + L * subs_per100
                                                 / 100.0))


def _one_hot(codes: torch.Tensor, dt) -> torch.Tensor:
    """[..., L] codes -> [..., 4L]: a 1 in channel 4k + b where base k is b
    (A, C, G, T); N and sentinels have no channel set."""
    oh = (codes[..., None] == torch.arange(4, device=codes.device,
                                           dtype=codes.dtype))
    return oh.reshape(*codes.shape[:-1], -1).to(dt)


def _revcomp(codes: np.ndarray) -> np.ndarray:
    rev = codes[:, ::-1]
    return np.where(rev < 4, 3 - rev, rev).astype(np.uint8)


def best_loci(seq: np.ndarray, reads: np.ndarray, device,
              block: int = 1 << 17) -> dict:
    """For each read [n, L]: the most matches over every locus and strand
    (`best`), how many loci reach it (`n_best`), the first such locus id
    pos * 2 + strand (`best_id`), and the second highest match count over
    all loci (`second`; equal to best where n_best > 1)."""
    dev = torch.device(device)
    # float16 holds every count up to L exactly, whatever the order of the
    # sums; the CPU multiplies in float32
    dt = torch.float16 if dev.type == "cuda" else torch.float32
    n, L = reads.shape
    G = len(seq)
    nwin = G - L + 1
    q = torch.from_numpy(np.concatenate([reads, _revcomp(reads)])).to(dev)
    Q = _one_hot(q, dt)                                        # [2n, 4L]
    g = torch.from_numpy(np.ascontiguousarray(seq)).to(dev)
    bad = (g >= SENTINEL).to(torch.int32)
    cb = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                    torch.cumsum(bad, 0, dtype=torch.int32)])
    b1 = torch.full((2 * n,), -1, dtype=torch.int32, device=dev)
    b2 = b1.clone()
    c1 = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    p1 = torch.zeros(2 * n, dtype=torch.int64, device=dev)
    lane = torch.arange(L, device=dev)
    for j0 in range(0, max(nwin, 0), block):
        j = torch.arange(j0, min(j0 + block, nwin), device=dev)
        ok = (cb[j + L] - cb[j]) == 0
        m = (Q @ _one_hot(g[j[:, None] + lane], dt).T).round().to(
            torch.int32)
        m = torch.where(ok[None], m, -1)
        k = min(2, m.shape[1])
        top, arg = m.topk(k, dim=1)
        v1 = top[:, 0]
        v2 = top[:, 1] if k == 2 else torch.full_like(v1, -1)
        cv = (m == v1[:, None]).sum(1)
        both = torch.stack([b1, b2, v1, v2], 1).sort(1, descending=True)[0]
        nb1, nb2 = both[:, 0], both[:, 1]
        c1 = torch.where(b1 == nb1, c1, 0) + torch.where(v1 == nb1, cv, 0)
        p1 = torch.where(b1 == nb1, p1, j0 + arg[:, 0])
        b1, b2 = nb1, nb2
    # the two strands of a read: rows r and n + r
    f, r = slice(0, n), slice(n, 2 * n)
    best = torch.maximum(b1[f], b1[r])
    n_best = torch.where(b1[f] == best, c1[f], 0) \
        + torch.where(b1[r] == best, c1[r], 0)
    strand = (b1[r] > b1[f]).to(torch.int64)
    pos = torch.where(strand == 1, p1[r], p1[f])
    allv = torch.stack([b1[f], b2[f], b1[r], b2[r]], 1).sort(
        1, descending=True)[0]
    return {"best": best.cpu().numpy().astype(np.int64),
            "n_best": n_best.cpu().numpy(),
            "best_id": (pos * 2 + strand).cpu().numpy(),
            "second": allv[:, 1].cpu().numpy().astype(np.int64)}


def align(seq: np.ndarray, reads: np.ndarray, rule: dict, device,
          max_mm: int | None = None) -> dict:
    """kalign's answer for each read: accepted (bool), pos, strand, nm
    (int64; pos, strand and nm -1 where not accepted). `rule` holds
    kalign's settings (max_subs, mm_delta, max_ns); `max_mm` overrides the
    mismatch limit they give."""
    L = reads.shape[1]
    if max_mm is None:
        max_mm = max_mismatches(L, int(rule["max_subs"]))
    bl = best_loci(seq, reads, device)
    low = L - bl["best"]
    nxt = L - bl["second"]
    max_ns = int(rule["max_ns"])
    ns_ok = (reads == 4).sum(1) <= max(L * max_ns // 100, max_ns)
    acc = ((low <= max_mm) & (bl["n_best"] == 1)
           & (nxt - low >= int(rule["mm_delta"])) & ns_ok)
    return {"accepted": acc,
            "pos": np.where(acc, bl["best_id"] >> 1, -1),
            "strand": np.where(acc, bl["best_id"] & 1, -1),
            "nm": np.where(acc, low, -1)}
