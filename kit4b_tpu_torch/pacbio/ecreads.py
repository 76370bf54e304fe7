"""ecreads: PacBio long-read error correction, the port of
kit4b_tpu/pacbio/ecreads.py.

Capability parity with CPBErrCorrect (pacbiokit4b/PBErrCorrect.cpp:6254):
for every probe read, find overlapping reads by seed cores against a suffix
index over the whole readset (CSfxArray::IteratePacBio, cores
cDfltSeedCoreLen=16 every cDfltDeltaCoreOfs=2, pacbiocommon.h:10-17), demand
>= cDfltNumSeedCores=20 diagonal-consistent cores per candidate, refine each
candidate with banded affine SW (CSSW::Align -> sswd.banded_sw_batch, all
candidates of a probe as fixed batches on `device`), then call a
multi-alignment consensus over the accepted overlaps (CMAConsensus ->
consensus.py). The index, the candidates and the consensus are host code
copied as they are; the batch shapes (the 4,096 grid of lengths, the fixed
batch of pad rows) are the JAX package's, so the SW engine sees the same
inputs and the same walk limit.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .. import dna
from ..align.blitz import _seed_hits
from ..io.fasta import Genome, SeqRecord
from ..index.sfx_index import SfxIndex
from .sswd import SWScores, banded_sw_batch
from .consensus import ConsensusBuilder

# pacbiocommon.h defaults
SEED_CORE_LEN = 16          # cDfltSeedCoreLen
DELTA_CORE_OFS = 2          # cDfltDeltaCoreOfs
MIN_NUM_SEED_CORES = 20     # cDfltNumSeedCores
MIN_SW_PEAK_SCORE = 50      # cMinSWPeakScore
MIN_SW_ALIGN_LEN = 50       # cMinSWAlignLen
MAX_OVERLAP_FLOAT = 1500    # cDfltMaxOverlapFloat


@dataclass
class ECParams:
    min_read_len: int = 1000        # cDfltMinPBSeqLen is 10000; scaled down
    min_corrected_len: int = 500    # cDfltMinErrCorrectLen scaled
    seed_core_len: int = SEED_CORE_LEN
    core_step: int = DELTA_CORE_OFS
    min_seed_cores: int = MIN_NUM_SEED_CORES
    band: int = 512                 # <= 2*cDfltMaxOverlapFloat
    min_score: int = MIN_SW_PEAK_SCORE
    min_align_len: int = MIN_SW_ALIGN_LEN
    min_coverage: int = 2           # consensus column quorum
    sw: SWScores = field(default_factory=lambda: SWScores(1, -2, -2, -1))
    batch: int = 32
    max_candidates: int = 64        # per probe (cSummaryTargCoreHitCnts cap)


def build_read_index(records: list[SeqRecord]) -> tuple[SfxIndex, Genome]:
    """Suffix index over the concatenated readset (reads as 'chromosomes')."""
    names = [r.name for r in records]
    seqs = [np.asarray(r.codes, np.uint8) for r in records]
    starts, lens, parts = [], [], []
    pos = 0
    for s in seqs:
        starts.append(pos)
        lens.append(len(s))
        parts.append(s)
        parts.append(np.array([dna.BASE_EOS], np.uint8))
        pos += len(s) + 1
    seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    seq[-1:] = dna.BASE_EOG
    g = Genome(names, np.asarray(starts, np.int64),
               np.asarray(lens, np.int64), seq)
    return SfxIndex.build(g), g


def _candidates(index: SfxIndex, g: Genome, probe: np.ndarray, self_id: int,
                p: ECParams):
    """Diagonal-consistent overlap candidates: (target_id, diag) pairs."""
    stride = p.core_step * 8    # sparser than the reference's stride-2 walk;
    # the seed-core quorum below is rescaled to match
    qps, tps = _seed_hits(index, probe, stride, max_per_seed=32)
    if len(qps) == 0:
        return []
    ci = np.searchsorted(g.starts, tps, side="right") - 1
    toff = tps - g.starts[ci]
    diag = toff - qps
    half = p.band // 2
    by_target: dict[int, list[int]] = {}
    for j in range(len(qps)):
        t = int(ci[j])
        if t != self_id:
            by_target.setdefault(t, []).append(int(diag[j]))
    quorum = max(2, p.min_seed_cores * p.core_step // stride)
    best = {}
    for t, ds in by_target.items():
        ds = np.sort(np.asarray(ds))
        # densest window of width band/2 in diagonal space; its median is
        # the band centre (symmetric drift headroom)
        hi = np.searchsorted(ds, ds + half, side="right")
        n = hi - np.arange(len(ds))
        j = int(np.argmax(n))
        if n[j] >= quorum:
            grp = ds[j: hi[j]]
            best[t] = (int(n[j]), int(np.median(grp)))
    out = [(t, d) for t, (n, d) in best.items()]
    out.sort(key=lambda td: -best[td[0]][0])
    return out[:p.max_candidates]


def correct_reads(records: list[SeqRecord], params: ECParams | None = None,
                  on_progress=None, device="cuda") -> list[SeqRecord]:
    """Error-correct every read >= min_read_len against the rest of the
    readset, the SW batches on `device`; returns corrected reads (>=
    min_corrected_len)."""
    p = params or ECParams()
    keep = [r for r in records if len(r.codes) >= p.min_read_len]
    if not keep:
        return []
    index, g = build_read_index(keep)
    corrected = []
    for pi, rec in enumerate(keep):
        probe = np.asarray(rec.codes, np.uint8)
        cands = _candidates(index, g, probe, pi, p)
        cb = ConsensusBuilder(probe)
        Lp = len(probe)
        for s in range(0, len(cands), p.batch):
            chunk = cands[s: s + p.batch]
            B = p.batch            # fixed batch of pad rows, as in JAX

            def quant(x, q=4096):
                # lengths padded to the JAX package's 4,096 grid (its
                # compile cache): the walk limit follows the padded length
                return -(-max(x, 1) // q) * q

            tmaxlen = quant(max(int(g.lengths[t]) for t, _ in chunk))
            Lpq = quant(Lp)
            probes = np.full((B, Lpq), 0x0F, np.uint8)
            targets = np.full((B, tmaxlen), 0x0F, np.uint8)
            plens = np.zeros(B, np.int32)
            plens[:len(chunk)] = Lp
            tlens = np.zeros(B, np.int32)
            diag0 = np.zeros(B, np.int32)
            for b, (t, d) in enumerate(chunk):
                probes[b, :Lp] = probe
                ts = int(g.starts[t])
                tl = int(g.lengths[t])
                targets[b, :tl] = g.seq[ts: ts + tl]
                tlens[b] = tl
                diag0[b] = d
            res = banded_sw_batch(probes, plens, targets, tlens, diag0,
                                  band=p.band, scores=p.sw, device=device)
            res = res[:len(chunk)]
            for b, a in enumerate(res):
                if (a.score >= p.min_score
                        and a.p_end - a.p_start >= p.min_align_len):
                    t = chunk[b][0]
                    ts = int(g.starts[t])
                    cb.add(a, g.seq[ts: ts + int(g.lengths[t])])
        cseq = cb.call(min_coverage=p.min_coverage)
        if len(cseq) >= p.min_corrected_len:
            corrected.append(SeqRecord(
                f"ecread_{pi+1}|{rec.name}|{cb.n_overlaps}", "", cseq))
        if on_progress:
            on_progress(pi + 1, len(keep))
    return corrected
