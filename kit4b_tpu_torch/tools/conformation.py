"""dsDNA conformation: octamer structural parameter tables, per-step
profiles, conformational distances, nucleosome dyad calling from MNase
reads and MNase fragment simulation, the port's copy of
kit4b_tpu/tools/conformation.py (host only; tests/test_torch_rehomed.py
holds it equal to the original statement for statement). A profile is one
gather: codes -> base-4 octamer indices -> the parameter's value table.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import dna

PROP_NAMES = [
    "twist", "roll", "tilt", "rise", "slide", "shift",
    "tristep_twist", "tristep_roll", "tristep_slide", "tristep_shift",
    "energy", "minorgroove", "rmsd",
    "qminus_twist", "qplus_twist", "qminus_roll", "qplus_roll",
    "tri_qminus_twist", "tri_qplus_twist", "tri_qminus_roll",
    "tri_qplus_roll", "orchid"]

_POW4 = (4 ** np.arange(7, -1, -1)).astype(np.int64)


def load_octamer_params(path) -> dict:
    """Octamer params CSV -> {prop: float32[65536]}. Octamers absent
    from the file inherit their reverse complement's values (the
    canonical-half convention); still-missing entries get the column
    mean."""
    vals = np.full((len(PROP_NAMES), 65536), np.nan, np.float32)
    with open(path) as f:
        for line in f:
            line = line.strip().replace("'", "").replace('"', "")
            if len(line) < 5:
                continue
            fields = line.split(",")
            oct_s = fields[0].strip().upper()
            if len(oct_s) != 8 or any(c not in "ACGT" for c in oct_s):
                continue
            try:
                row = [float(x) for x in fields[1:1 + len(PROP_NAMES)]]
            except ValueError:
                continue
            codes = dna.encode(oct_s).astype(np.int64)
            idx = int((codes * _POW4).sum())
            vals[:len(row), idx] = row
            rc = dna.revcomp(codes.astype(np.uint8)).astype(np.int64)
            ridx = int((rc * _POW4).sum())
            if np.isnan(vals[0, ridx]):
                vals[:len(row), ridx] = row
    out = {}
    for pi, name in enumerate(PROP_NAMES):
        col = vals[pi]
        if np.isnan(col).all():
            continue
        fill = np.nanmean(col)
        out[name] = np.where(np.isnan(col), fill, col)
    return out


def octamer_indices(codes: np.ndarray) -> np.ndarray:
    """Sliding octamer base-4 indices; -1 where any base is ambiguous.
    Index i covers codes[i:i+8] (the step between bases i+3 and i+4)."""
    c = np.asarray(codes, np.int64)
    n = len(c) - 7
    if n <= 0:
        return np.zeros(0, np.int64)
    win = np.lib.stride_tricks.sliding_window_view(c, 8)
    bad = (win > 3).any(axis=1)
    idx = win @ _POW4
    return np.where(bad, -1, idx)


def struct_profile(codes: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Per-step conformational values for one property (float32;
    NaN at ambiguous-base steps)."""
    idx = octamer_indices(codes)
    out = np.full(len(idx), np.nan, np.float32)
    ok = idx >= 0
    out[ok] = values[idx[ok]]
    return out


def write_struct_csv(path, name: str, profile: np.ndarray,
                     prop: str) -> None:
    with open(path, "w") as f:
        f.write(f'"Seq","Step","{prop}"\n')
        for i, v in enumerate(profile):
            if not np.isnan(v):
                f.write(f'"{name}",{i + 4},{v:.4f}\n')


def conformational_distances(seqs: list, params: dict,
                             props: list | None = None) -> np.ndarray:
    """fasta2dist: pairwise Euclidean distance between sequences'
    mean conformational property vectors."""
    props = props or list(params)
    feats = np.zeros((len(seqs), len(props)), np.float64)
    for si, rec in enumerate(seqs):
        for pi, p in enumerate(props):
            prof = struct_profile(rec.codes, params[p])
            feats[si, pi] = np.nanmean(prof) if len(prof) else 0.0
    # standardize so no property dominates
    std = feats.std(axis=0)
    std[std == 0] = 1.0
    z = (feats - feats.mean(axis=0)) / std
    d2 = ((z[:, None, :] - z[None, :, :]) ** 2).sum(axis=2)
    return np.sqrt(d2)


def write_dist_csv(path, names: list, dist: np.ndarray) -> None:
    with open(path, "w") as f:
        f.write('"Seq",' + ",".join(f'"{n}"' for n in names) + "\n")
        for i, n in enumerate(names):
            f.write(f'"{n}",' + ",".join(f"{v:.4f}" for v in dist[i])
                    + "\n")


# --------------------------------------------- nucleosome dyad calling

NUC_LEN = 147


@dataclass
class Dyad:
    chrom: str
    pos: int
    score: float


def dyad_scores(alignments, chrom_lens: dict, *, mode: int = 0,
                len_tol: int = 20) -> dict:
    """prednucleosomes: stack read dyad centres per chromosome.

    alignments: iterable of (chrom, start0, length, tlen) tuples.
    mode 0: paired reads with |TLEN| within 147 +/- len_tol — dyad at
    fragment centre; mode 1: full-length ~147bp reads; mode 2: any read
    extended to 147bp from its 5' start.
    """
    scores = {c: np.zeros(int(n), np.float32) for c, n in
              chrom_lens.items()}
    for chrom, start, length, tlen in alignments:
        if chrom not in scores:
            continue
        if mode == 0:
            if tlen <= 0 or abs(tlen - NUC_LEN) > len_tol:
                continue
            centre = start + tlen // 2
        elif mode == 1:
            if abs(length - NUC_LEN) > len_tol:
                continue
            centre = start + length // 2
        else:
            centre = start + NUC_LEN // 2
        if 0 <= centre < len(scores[chrom]):
            scores[chrom][centre] += 1.0
    return scores


def call_dyads(scores: dict, *, min_score: float = 3.0,
               smooth: int = 21, spacing: int = NUC_LEN) -> list[Dyad]:
    """Smoothed local maxima with minimum inter-dyad spacing."""
    out = []
    kern = np.ones(smooth, np.float32) / smooth
    for chrom, sc in scores.items():
        if not sc.any():
            continue
        sm = np.convolve(sc, kern, mode="same")
        order = np.argsort(-sm)
        taken = np.zeros(len(sm), bool)
        for p in order:
            if sm[p] * smooth < min_score:
                break
            if taken[p]:
                continue
            # centre on the equal-score plateau (box smoothing of one
            # stacked dyad position yields a flat window)
            a = b = int(p)
            while a > 0 and sm[a - 1] == sm[p]:
                a -= 1
            while b + 1 < len(sm) and sm[b + 1] == sm[p]:
                b += 1
            c = (a + b) // 2
            out.append(Dyad(chrom, c, float(sm[p] * smooth)))
            lo, hi = max(0, c - spacing + 1), min(len(sm), c + spacing)
            taken[lo:hi] = True
    out.sort(key=lambda d: (d.chrom, d.pos))
    return out


def write_dyads(path, dyads: list, fmt: str = "bedgraph") -> None:
    with open(path, "w") as f:
        if fmt == "bedgraph":
            f.write('track type=bedGraph name="dyads"\n')
            for d in dyads:
                f.write(f"{d.chrom}\t{d.pos}\t{d.pos + 1}"
                        f"\t{d.score:.1f}\n")
        elif fmt == "bed":
            f.write('track name="nucleosomes"\n')
            for i, d in enumerate(dyads):
                s = max(0, d.pos - NUC_LEN // 2)
                f.write(f"{d.chrom}\t{s}\t{d.pos + NUC_LEN // 2 + 1}"
                        f"\tnuc{i + 1}\t{min(1000, int(d.score * 10))}"
                        f"\t+\n")
        else:
            f.write('"Chrom","Dyad","Score"\n')
            for d in dyads:
                f.write(f'"{d.chrom}",{d.pos},{d.score:.2f}\n')


def simulate_mnase(genome, n_frags: int, *, seed: int = 1,
                   len_tol: int = 10,
                   site_pref: dict | None = None) -> list:
    """SimulateMNase: sample ~147bp fragments whose cut sites follow
    MNase dinucleotide preference (default: strong at A/T steps —
    MNase cuts 5' of A or T). Returns (chrom, start, length) tuples."""
    rng = np.random.default_rng(seed)
    pref = site_pref or {0: 1.0, 3: 1.0, 1: 0.05, 2: 0.05}
    out = []
    lens = np.asarray(genome.lengths, np.int64)
    probs = lens / lens.sum()
    w = np.zeros(4)
    for b, p in pref.items():
        w[b] = p
    for _ in range(n_frags):
        ci = int(rng.choice(len(lens), p=probs))
        L = int(lens[ci])
        if L < NUC_LEN + 2 * len_tol + 2:
            continue
        frag_len = NUC_LEN + int(rng.integers(-len_tol, len_tol + 1))
        for _ in range(32):
            s = int(rng.integers(1, L - frag_len - 1))
            gofs = int(genome.starts[ci])
            b5 = genome.seq[gofs + s]
            b3 = genome.seq[gofs + s + frag_len]
            p5 = w[b5] if b5 < 4 else 0.0
            p3 = w[b3] if b3 < 4 else 0.0
            if rng.random() < p5 * p3:
                out.append((genome.names[ci], s, frag_len))
                break
    return out
