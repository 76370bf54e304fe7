"""filter: PacBio SMRTbell hairpin filtering (CPBFilter equivalent), the
port of kit4b_tpu/pacbio/pbfilter.py; the SW batches run on `device`.

The reference detects retained SMRTbell adapter hairpins — a read that runs
through the adapter reads back through its own reverse complement — by
self-alignment (pacbiokit4b/PBFilter.cpp). Here every read is aligned
against its own reverse complement with the banded SW engine; a strong
palindromic hit centred near some position marks the hairpin, the read is
split there, and subreads >= min_len are retained. Reads without a
significant self-rc alignment pass through unchanged."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..io.fasta import SeqRecord
from .sswd import SWScores, banded_sw_batch


@dataclass
class FilterParams:
    min_len: int = 500            # cMinPBSeqLen
    min_hairpin_score: int = 100  # self-rc alignment evidence threshold
    band: int = 512
    trim: int = 0                 # 5'/3' trim applied to retained subreads
    batch: int = 16
    sw: SWScores = field(default_factory=lambda: SWScores(1, -2, -2, -1))


def _revcomp(s: np.ndarray) -> np.ndarray:
    r = s[::-1]
    return np.where(r < 4, 3 - r, r).astype(np.uint8)


def _self_rc_diag(c: np.ndarray, k: int = 16, min_votes: int = 4):
    """Best diagonal of c vs revcomp(c): a hairpin folded at f puts the
    arm-vs-arm alignment on the constant diagonal L - 2f. Returns the diag
    with most k-mer votes, or None."""
    L = len(c)
    if L < 2 * k:
        return None
    rc = _revcomp(c)
    pw = 4 ** np.arange(k - 1, -1, -1, dtype=np.int64)
    w = np.lib.stride_tricks.sliding_window_view(c, k)
    wr = np.lib.stride_tricks.sliding_window_view(rc, k)
    okp = (w < 4).all(axis=1)
    okr = (wr < 4).all(axis=1)
    keys_r: dict[int, list[int]] = {}
    kr = (wr.astype(np.int64) * pw).sum(axis=1)
    for j in np.nonzero(okr)[0][::4]:
        keys_r.setdefault(int(kr[j]), []).append(int(j))
    kp = (w.astype(np.int64) * pw).sum(axis=1)
    votes: dict[int, int] = {}
    for i in np.nonzero(okp)[0][::4]:
        for j in keys_r.get(int(kp[i]), ()):
            d = (j - i) // 32   # coarse diagonal buckets
            votes[d] = votes.get(d, 0) + 1
    if not votes:
        return None
    d, n = max(votes.items(), key=lambda kv: kv[1])
    return d * 32 if n >= min_votes else None


def filter_reads(records: list[SeqRecord],
                 params: FilterParams | None = None, device="cuda"
                 ) -> tuple[list[SeqRecord], dict]:
    """Returns (retained subreads, stats). Hairpin candidates are seeded by
    k-mer diagonal votes of read vs own-rc, confirmed with banded SW on
    that diagonal, and the read is split at the fold f = (L - diag) / 2."""
    p = params or FilterParams()
    out: list[SeqRecord] = []
    stats = {"in": 0, "hairpins": 0, "retained": 0, "dropped_short": 0}

    def emit(r, parts):
        for j, part in enumerate(parts):
            if p.trim:
                part = part[p.trim: len(part) - p.trim]
            if len(part) >= p.min_len:
                nm = r.name if len(parts) == 1 else f"{r.name}/sub{j+1}"
                out.append(SeqRecord(nm, "", np.asarray(part, np.uint8)))
                stats["retained"] += 1
            else:
                stats["dropped_short"] += 1

    cand: list[tuple[SeqRecord, int]] = []
    for r in records:
        stats["in"] += 1
        c = np.asarray(r.codes, np.uint8)
        d = _self_rc_diag(c)
        if d is None:
            emit(r, [c])
        else:
            cand.append((r, d))

    for s in range(0, len(cand), p.batch):
        chunk = cand[s: s + p.batch]
        B = p.batch
        L = max(len(r.codes) for r, _ in chunk)
        probes = np.full((B, L), 0x0F, np.uint8)
        targets = np.full((B, L), 0x0F, np.uint8)
        plens = np.zeros(B, np.int32)
        tlens = np.zeros(B, np.int32)
        diag0 = np.zeros(B, np.int32)
        for b, (r, d) in enumerate(chunk):
            c = np.asarray(r.codes, np.uint8)
            probes[b, :len(c)] = c
            targets[b, :len(c)] = _revcomp(c)
            plens[b] = tlens[b] = len(c)
            diag0[b] = d
        res = banded_sw_batch(probes, plens, targets, tlens, diag0,
                              band=p.band, scores=p.sw, device=device)
        for b, (r, d) in enumerate(chunk):
            c = np.asarray(r.codes, np.uint8)
            a = res[b]
            if a.score >= p.min_hairpin_score:
                stats["hairpins"] += 1
                fold = int(np.clip((len(c) - d) // 2, 1, len(c) - 1))
                emit(r, [c[:fold], c[fold:]])
            else:
                emit(r, [c])
    return out, stats
