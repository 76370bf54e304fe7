"""The seeded workload of the kmarkers golden file and the arrays it holds.

`kit4b_tpu_torch/data/kmarkers_golden.npz` holds the JAX package's answers
on this workload; `python tests/test_torch_kmarkers_golden.py` regenerates
it (JAX on the CPU). A machine without JAX rebuilds the same inputs with
`workload()` and `restricted_cases()`, which use numpy and the port's own
host modules, runs the port with `compute_kmarkers()` and
`compute_restricted()` and compares: that is how the
port is held to the JAX package on the card.

The workload is three cultivars of 36 kbp in one pseudo-genome (target
cult0), built so that every shortcut of the pass shows:
  - a 70 bp unit planted 28 times in the target, a third of the copies
    reverse-complemented: its positions saturate tier 1 and resolve in
    tier 2 (4096, 256, 128), accepted at the first copy only;
  - a 280 bp (AC) tandem run, which saturates tier 2 and resolves in
    tier 3 (1024, 2048, 512), and a 600 bp poly-A run, whose positions
    still saturate tier 3 and are dropped;
  - a 200 bp segment copied twice more in the target, once on each
    strand (the in-target duplicate rule);
  - N runs of 1, 3 and 30 bases in the target (windows with 1-4 and with
    5 or more Ns);
  - Hamming-1 and Hamming-2 neighbours of windows of the target's private
    block in cult1 and cult2, forward and reverse-complemented, with the
    differences inside and outside the first seed core;
  - tier-1 batches of 8,192 positions, so the last one is padded.
Each escalation tier takes one batch. For min_hamming 1, 2 and 3 the file
holds the tier-1 pass codes batch by batch, the positions run in each tier
and dropped after the last, and the markers of `find_cultivar_markers` with
and without run extension (chrom index, start, length) with the SHA-256 of
their FASTA. It also holds `hammings_restricted`'s output on four genomes:
the three of the JAX package's tests (tests/test_hammings.py), and 12 kbp
of the target (the repeats, the duplicate and the N runs) with 2 kbp of
cult1 (its neighbours) at the default lut_k, K 25, -r 3, batches of 1,024.
"""
from __future__ import annotations

import hashlib
import tempfile
from pathlib import Path

import numpy as np

from .. import dna
from ..index.sfx_index import SfxIndex
from ..io.fasta import Genome, SeqRecord

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "kmarkers_golden.npz"
SEED = 20251016
CULT_LEN = 36_000
K = 50
BATCH = 8192
TARGET = 0
MIN_HAMMINGS = (1, 2, 3)
RESTRICTED_K, RESTRICTED_H, RESTRICTED_BATCH = 25, 3, 1024


def _mutate(rng, win, offsets):
    w = win.copy()
    w[offsets] = (w[offsets] + rng.integers(1, 4, len(offsets))) % 4
    return w


def cultivars() -> list[np.ndarray]:
    """The three cultivars' codes, seeded (see the module docstring)."""
    rng = np.random.default_rng(SEED)
    backbone = rng.integers(0, 4, CULT_LEN).astype(np.uint8)
    cults = []
    for _ in range(3):
        seq = backbone.copy()
        snps = rng.choice(CULT_LEN, CULT_LEN // 200, replace=False)
        seq[snps] = (seq[snps] + rng.integers(1, 4, len(snps))) % 4
        cults.append(seq)
    t = cults[TARGET]
    private = rng.integers(0, 4, 1500).astype(np.uint8)
    t[2000:3500] = private
    unit = rng.integers(0, 4, 70).astype(np.uint8)
    for i in range(28):
        p = 5000 + 500 * i
        t[p:p + 70] = dna.revcomp(unit) if i % 3 == 2 else unit
    t[26000:26280] = np.tile(np.array([0, 1], np.uint8), 140)     # (AC)140
    t[27000:27600] = 0                                            # poly-A
    dup = t[28500:28700].copy()
    t[29500:29700] = dup
    t[30500:30700] = dna.revcomp(dup)
    t[31500] = t[32000:32003] = t[33000:33030] = dna.BASE_N
    # neighbours in cult1 (forward) and cult2 (reverse-complemented) of
    # private windows: Hamming 1 and 2, inside and past the first core
    for j, (cult, rc) in enumerate(((1, False), (2, True))):
        for h, offs in enumerate(([5], [40], [3, 20], [30, 45])):
            src = 2000 + 150 * (4 * j + h)
            w = _mutate(rng, t[src:src + K], np.array(offs))
            d = 34000 + 200 * h
            cults[cult][d:d + K] = dna.revcomp(w) if rc else w
    return cults


def pseudogenome() -> Genome:
    """The cultivars as `kmarkers.build_pseudogenome` lays them out: one
    chromosome a cultivar, named `cult<i>.chr1`, cultivar i."""
    return Genome.from_records([SeqRecord(f"cult{i}.chr1", "", c)
                                for i, c in enumerate(cultivars())])


def workload():
    """(genome, index, chrom_cult, cultivar names) of the pseudo-genome."""
    g = pseudogenome()
    return g, SfxIndex.build(g), np.arange(3, dtype=np.int32), \
        [f"cult{i}" for i in range(3)]


def restricted_cases():
    """(name, genome, lut_k, K, max_hamming, batch) of the restricted
    golden: the genomes of tests/test_hammings.py's
    test_restricted_matches_oracle_capped and test_restricted_n_enumeration
    (rebuilt here from their seeds), and a part of the workload."""
    cults = cultivars()
    rng = np.random.default_rng(21)
    n = 2000
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[500:532] = g[100:132]
    g[800:832] = g[200:232]
    g[803] = (g[803] + 1) % 4
    g[850:882] = ((g[250:282] + 1) % 4)
    seq = np.concatenate([g, [dna.BASE_EOG]]).astype(np.uint8)
    capped = Genome(["c"], np.array([0]), np.array([n]), seq)
    rng = np.random.default_rng(13)
    a = rng.integers(0, 4, 400).astype(np.uint8)
    a[200:216] = a[100:116]
    b = a.copy()
    b[300:316] = a[100:116]
    b[308] = 4
    c = a.copy()
    c[50:56] = 4
    return [("capped", capped, 8, 32, 3, 512),
            ("one_n", Genome.from_records([SeqRecord("c", "", b)]), 8, 16,
             3, 512),
            ("many_n", Genome.from_records([SeqRecord("c", "", c)]), 8, 16,
             3, 512),
            ("workload", Genome.from_records(
                [SeqRecord("cult0", "", cults[0][24000:]),
                 SeqRecord("cult1", "", cults[1][33500:35500])]),
             None, RESTRICTED_K, RESTRICTED_H, RESTRICTED_BATCH)]


def inputs_sha256() -> str:
    h = hashlib.sha256()
    for _, g, lut_k, k, mh, batch in restricted_cases():
        h.update(g.seq.tobytes())
        h.update(repr((g.names, g.starts.tolist(), lut_k, k, mh, batch,
                       K, BATCH, TARGET)).encode())
    return h.hexdigest()


def tier1_batches(g: Genome, chrom_cult: np.ndarray) -> list[np.ndarray]:
    """The tier-1 batches of `find_cultivar_markers` at BATCH: int32
    positions, the last batch of a chromosome padded with its first."""
    out = []
    for ci in np.nonzero(chrom_cult == TARGET)[0]:
        cstart, clen = int(g.starts[ci]), int(g.lengths[ci])
        pos = np.arange(cstart, cstart + clen - K + 1, dtype=np.int64)
        for s in range(0, len(pos), BATCH):
            qp = pos[s:s + BATCH]
            out.append(np.concatenate([qp, np.full(BATCH - len(qp), cstart)])
                       .astype(np.int32))
    return out


def compute_kmarkers(find_markers, pass_codes, write_markers_fasta) -> dict:
    """The golden's kmarkers arrays from one implementation:
    find_markers(min_hamming, extend) -> (markers, {"tier1", "tier2",
    "tier3", "dropped"}); pass_codes(min_hamming, qp int32 [BATCH]) ->
    int8 codes of the tier-1 pass; write_markers_fasta as in kmarkers."""
    g = pseudogenome()
    batches = tier1_batches(g, np.arange(3))
    out = {}
    for mh in MIN_HAMMINGS:
        out[f"codes_e{mh}"] = np.stack(
            [np.asarray(pass_codes(mh, qp), np.int8) for qp in batches])
        for extend in (False, True):
            markers, tiers = find_markers(mh, extend)
            key = f"m{int(extend)}_e{mh}"
            out[f"markers_{key}"] = np.array(
                [(g.names.index(m.chrom), m.start, m.length)
                 for m in markers], np.int64).reshape(-1, 3)
            with tempfile.TemporaryDirectory() as tmp:
                fa = Path(tmp) / "markers.fa"
                write_markers_fasta(fa, markers)
                out[f"fasta_sha256_{key}"] = np.array(
                    hashlib.sha256(fa.read_bytes()).hexdigest())
            out[f"tiers_e{mh}"] = np.array(
                [tiers[k] for k in ("tier1", "tier2", "tier3", "dropped")],
                np.int64)
    return out


def compute_restricted(restricted) -> dict:
    """The golden's restricted arrays from one implementation:
    restricted(genome, lut_k, K, max_hamming, batch) -> uint16 [G]."""
    return {f"restricted_{name}": np.asarray(
        restricted(rg, lut_k, k, mh, batch), np.uint16)
        for name, rg, lut_k, k, mh, batch in restricted_cases()}


def port_fns(device):
    """(find_markers, pass_codes, write_markers_fasta, restricted): the
    callables of compute_kmarkers() and compute_restricted() for the port
    on `device`."""
    import torch

    from ..kmer import hammings, kmarkers
    g, idx, chrom_cult, _ = workload()

    positions = {}      # min_hamming -> (accepted, stats): one run each

    def find_markers(mh, extend):
        if mh not in positions:
            stats = {}
            positions[mh] = (kmarkers.marker_positions(
                idx, chrom_cult, TARGET, kmer_len=K, min_hamming=mh,
                batch=BATCH, device=device, stats=stats), stats)
        acc, stats = positions[mh]
        return kmarkers.extend_markers(g, acc, K, extend), stats

    gview, sa, lut = kmarkers._fast_device_arrays(idx, K, device)
    genome = torch.from_numpy(g.seq).to(device)
    starts = torch.from_numpy(g.starts.astype(np.int32)).to(device)
    cult = torch.from_numpy(chrom_cult).to(device)

    def pass_codes(mh, qp):
        return kmarkers.kmarkers_pass(
            gview, sa, lut, genome, starts, cult,
            torch.from_numpy(qp).to(device), K=K, genome_len=len(g.seq),
            offsets=kmarkers.core_offsets(K, mh, idx.lut_k),
            lut_k=idx.lut_k, n_compact=24, max_ml=48,
            min_hamming=mh, target=TARGET).cpu().numpy()

    def restricted(rg, lut_k, k, mh, batch):
        return hammings.hammings_restricted(
            SfxIndex.build(rg, lut_k), k, max_hamming=mh, batch=batch,
            device=device)
    return find_markers, pass_codes, kmarkers.write_markers_fasta, restricted
