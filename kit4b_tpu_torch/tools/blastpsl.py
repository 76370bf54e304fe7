"""BLAST tabular and UCSC PSL to CSV converters, the port's copy of
kit4b_tpu/tools/blastpsl.py (host only; tests/test_torch_rehomed.py holds
it equal to the original statement for statement): both parse alignment
reports, apply target-chrom regex include/exclude filters and write the
reference's CSV headers.
"""
from __future__ import annotations

import re


def _chrom_ok(chrom: str, exc: list, inc: list) -> bool:
    if exc and any(p.search(chrom) for p in exc):
        return False
    if inc and not any(p.search(chrom) for p in inc):
        return False
    return True


def blast2csv(in_path, out_path, *, chrom_exclude: list | None = None,
              chrom_include: list | None = None) -> int:
    """blast2csv: convert BLAST -m8/-m9 tabular output to CSV
    (blast2csv.cpp OutputCSV header). Strand is inferred from subject
    start>end ordering; coordinates are normalised ascending."""
    exc = [re.compile(p) for p in (chrom_exclude or [])]
    inc = [re.compile(p) for p in (chrom_include or [])]
    n = 0
    with open(in_path) as fi, open(out_path, "w") as fo:
        fo.write('"QueryID","SubjectID","Strand","Identity","AlignLen",'
                 '"Mismatches","GapOpenings","QueryStart","QueryEnd",'
                 '"SubjectStart","SubjectEnd","Expect","BitScore"\n')
        for line in fi:
            if not line.strip() or line.startswith("#"):
                continue
            t = line.split("\t")
            if len(t) < 12:
                t = line.split()
            if len(t) < 12:
                continue
            q, s = t[0], t[1]
            if not _chrom_ok(s, exc, inc):
                continue
            ss, se = int(t[8]), int(t[9])
            strand = "+" if se >= ss else "-"
            if se < ss:
                ss, se = se, ss
            fo.write(f'"{q}","{s}","{strand}",{float(t[2]):.4f},{t[3]},'
                     f'{t[4]},{t[5]},{t[6]},{t[7]},{ss},{se},'
                     f'{float(t[10]):.3g},{float(t[11]):.3g}\n')
            n += 1
    return n


def psl2csv(in_path, out_path, *, chrom_exclude: list | None = None,
            chrom_include: list | None = None) -> int:
    """psl2csv: convert UCSC PSL (21-field, optional psLayout header) to
    the reference CSV layout (psl2csv.cpp:565-582) including per-block
    lists."""
    exc = [re.compile(p) for p in (chrom_exclude or [])]
    inc = [re.compile(p) for p in (chrom_include or [])]
    n = 0
    with open(in_path) as fi, open(out_path, "w") as fo:
        fo.write('"QName","QLen","QAlignLen","QStart","QEnd","TName",'
                 '"TStrand","TLen","TAlignLen","TStart","TEnd","Matches",'
                 '"Mismatches","MatchNonRepeats","MatchRepeats","NBases",'
                 '"QNumInDels","QInDelsBases","TNumInDels","TInDelsBases",'
                 '"BlockCnt","BlockLens","QBlockStarts","TBlockStarts"\n')
        for line in fi:
            t = line.rstrip("\n").split("\t")
            if len(t) < 21 or not t[0].isdigit():
                continue
            (matches, mism, rep, ncount, qgapc, qgapb, tgapc, tgapb,
             strand, qname, qsize, qstart, qend, tname, tsize, tstart,
             tend, blockcount, blocksizes, qstarts, tstarts) = t[:21]
            if not _chrom_ok(tname, exc, inc):
                continue
            qalign = int(qend) - int(qstart)
            talign = int(tend) - int(tstart)
            fo.write(f'"{qname}",{qsize},{qalign},{qstart},{qend},'
                     f'"{tname}","{strand}",{tsize},{talign},{tstart},'
                     f'{tend},{int(matches) + int(rep)},{mism},{matches},'
                     f'{rep},{ncount},{qgapc},{qgapb},{tgapc},{tgapb},'
                     f'{blockcount},"{blocksizes}","{qstarts}",'
                     f'"{tstarts}"\n')
            n += 1
    return n
