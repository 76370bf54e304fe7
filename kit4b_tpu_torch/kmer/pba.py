"""PBA (Packed Base Alleles): per-locus allele scores in one byte. The
port's copy of kit4b_tpu/kmer/pba.py, whole: the scoring `kalign -3` and
`genpba` write, both containers (`save_pba`/`load_pba`, and the
reference's binary layout `save_pba_ref`/`load_pba_ref`, picked by
`load_pba_any`), and pbautils' `concat_pba` and `pba_coverage_wig`.

Capability parity with genpba (ngskit4b/KAlignerCL.cpp:1491 kalignerPBA):
each locus packs four 2-bit allele scores, A in bits 7.6, C in 5.4, G in
3.2, T in 1.0 (CallHaplotypes.h:31), scored from allele proportions with
the reference's coverage-dependent thresholds (CallHaplotypes.h:33-39):

  coverage >= 5:  3 if prop >= 0.75, 2 if >= 0.35, 1 if >= 0.20
  coverage <  5:  2 if prop >= 0.70, 1 if >= 0.30

Containers: .pba.npz holding per-chromosome byte arrays + names, and
the reference's 'Type:PbA\\nVersion:1' binary layout (save_pba_ref).
"""
from __future__ import annotations

import numpy as np

SCORE3_MIN = 0.75
SCORE2_MIN = 0.35
SCORE1_MIN = 0.20
SCORE2_LC = 0.70
SCORE1_LC = 0.30
MIN_COV = 5


def pba_from_counts(counts: np.ndarray) -> np.ndarray:
    """counts [G, >=4] (A,C,G,T[,N]) -> PBA bytes [G] (vectorized)."""
    acgt = counts[:, :4].astype(np.float64)
    cov = acgt.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        prop = np.where(cov[:, None] > 0, acgt / np.maximum(cov[:, None], 1),
                        0.0)
    hi = cov[:, None] >= MIN_COV
    score = np.zeros(acgt.shape, np.uint8)
    score = np.where(hi & (prop >= SCORE1_MIN), 1, score)
    score = np.where(hi & (prop >= SCORE2_MIN), 2, score)
    score = np.where(hi & (prop >= SCORE3_MIN), 3, score)
    score = np.where(~hi & (prop >= SCORE1_LC), 1, score)
    score = np.where(~hi & (prop >= SCORE2_LC), 2, score)
    score = np.where(cov[:, None] == 0, 0, score)
    # pack: A<<6 | C<<4 | G<<2 | T
    return ((score[:, 0].astype(np.uint8) << 6)
            | (score[:, 1] << 4) | (score[:, 2] << 2)
            | score[:, 3]).astype(np.uint8)


def unpack_pba(pba: np.ndarray) -> np.ndarray:
    """PBA bytes [G] -> scores [G, 4] (A,C,G,T)."""
    p = np.asarray(pba, np.uint8)
    return np.stack([(p >> 6) & 3, (p >> 4) & 3, (p >> 2) & 3, p & 3],
                    axis=1).astype(np.uint8)


def save_pba(path, genome, pba_concat: np.ndarray,
             readset: str = "readset") -> None:
    """Split concatenated-genome PBA bytes into per-chrom arrays and save."""
    arrays = {}
    for i, name in enumerate(genome.names):
        s = int(genome.starts[i])
        arrays[f"chrom:{name}"] = pba_concat[s: s + int(genome.lengths[i])]
    np.savez_compressed(path, readset=np.array(readset),
                        names=np.array(genome.names, dtype=object),
                        **arrays)


def load_pba(path) -> tuple[str, dict]:
    z = np.load(path, allow_pickle=True)
    names = list(z["names"])
    return str(z["readset"]), {n: z[f"chrom:{n}"] for n in names}


def save_pba_ref(path, chroms: dict, *, readset: str = "readset",
                 experiment: str = "E1", ref_assembly: str = "ref") -> None:
    """Write a REFERENCE-binary-format PBA file (the layout ngskit4b's
    callhaplotypes/dgts/pbautils load, CallHaplotypes.cpp:5159-5280):
    text header 'Type:PbA\\nVersion:1\\nExperimentID:..\\nReferenceID:..\\n
    ReadsetID:..' NUL-terminated (KAligner.cpp:7224), then per chromosome
    [nameLen:u8][name][NUL][chromLen:i32le][PBA bytes]. Enables direct
    interop + golden tests against the reference binary."""
    with open(path, "wb") as f:
        hdr = (f"Type:PbA\nVersion:1\nExperimentID:{experiment}\n"
               f"ReferenceID:{ref_assembly}\nReadsetID:{readset}")
        f.write(hdr.encode() + b"\0")
        for name, pba in chroms.items():
            nb = name.encode()
            f.write(bytes([len(nb)]) + nb + b"\0")
            f.write(np.int32(len(pba)).tobytes())
            f.write(np.asarray(pba, np.uint8).tobytes())


def load_pba_ref(path) -> tuple[str, dict]:
    """Read a reference-binary-format PBA file (see save_pba_ref)."""
    with open(path, "rb") as f:
        data = f.read()
    nul = data.index(b"\0")
    hdr = data[:nul].decode()
    tags = dict(line.split(":", 1) for line in hdr.split("\n"))
    if tags.get("Version") != "1":
        raise ValueError(f"unsupported PBA version in {path}")
    chroms = {}
    ofs = nul + 1
    while ofs + 6 <= len(data):
        nlen = data[ofs]
        name = data[ofs + 1: ofs + 1 + nlen].decode()
        ofs += nlen + 2
        clen = int(np.frombuffer(data[ofs:ofs + 4], np.int32)[0])
        ofs += 4
        chroms[name] = np.frombuffer(data[ofs:ofs + clen], np.uint8).copy()
        ofs += clen
    return tags.get("ReadsetID", ""), chroms


def load_pba_any(path) -> tuple[str, dict]:
    """Load a PBA file in either container: .npz (this framework) or the
    reference's binary layout (header 'Type:PbA\\nVersion:1\\n...')."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic.startswith(b"Type:PbA"):
        return load_pba_ref(path)
    return load_pba(path)


def pba_coverage_wig(path, out_path, min_score: int = 1) -> None:
    """pbautils coverage mode: per-chrom spans where any allele scores >=
    min_score -> WIG."""
    _, chroms = load_pba(path)
    with open(out_path, "w") as f:
        f.write('track type=wiggle_0 name="pba_coverage"\n')
        for name, pba in chroms.items():
            sc = unpack_pba(pba).max(axis=1)
            cov = (sc >= min_score).astype(np.int8)
            if not cov.any():
                continue
            d = np.diff(cov)
            starts = np.concatenate(
                [[0] if cov[0] else [], np.nonzero(d == 1)[0] + 1]).astype(
                    np.int64)
            ends = np.concatenate(
                [np.nonzero(d == -1)[0] + 1,
                 [len(cov)] if cov[-1] else []]).astype(np.int64)
            for a, b in zip(starts, ends):
                f.write(f"variableStep chrom={name} span={b - a}\n")
                f.write(f"{a + 1}\t1\n")


def concat_pba(paths: list, out_path) -> None:
    """pbautils concat: merge same-chromosome PBAs (max score per allele)."""
    merged: dict = {}
    names_order: list[str] = []
    readset = "concat"
    for p in paths:
        rs, chroms = load_pba(p)
        for name, pba in chroms.items():
            if name in merged:
                a = unpack_pba(merged[name])
                b = unpack_pba(pba)
                n = min(len(a), len(b))
                mx = np.maximum(a[:n], b[:n])
                out = ((mx[:, 0].astype(np.uint8) << 6) | (mx[:, 1] << 4)
                       | (mx[:, 2] << 2) | mx[:, 3]).astype(np.uint8)
                if len(a) > n:
                    out = np.concatenate([out, merged[name][n:]])
                elif len(b) > n:
                    out = np.concatenate([out, pba[n:]])
                merged[name] = out
            else:
                merged[name] = pba.copy()
                names_order.append(name)
    np.savez_compressed(out_path, readset=np.array(readset),
                        names=np.array(names_order, dtype=object),
                        **{f"chrom:{n}": merged[n] for n in names_order})
