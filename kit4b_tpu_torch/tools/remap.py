"""remaploci: remap SAM or BED alignment loci between assemblies, the port's
copy of kit4b_tpu/tools/remap.py (host only; tests/test_torch_rehomed.py
holds it equal to the original statement for statement): loci inside a
feature of the remapping BED move onto the coordinates of the sequence the
feature names, strand-aware.
"""
from __future__ import annotations

from ..io.bed import BedFile


def _remap(bed: BedFile, chrom: str, pos: int):
    """(new_chrom, new_pos) or None if no containing feature."""
    for ft in bed.contains(chrom, pos):
        if ft.strand == "-":
            return ft.name, (ft.end - 1) - pos
        return ft.name, pos - ft.start
    return None


def remap_sam(inpath, bedpath, outpath) -> dict:
    bed = BedFile.load(bedpath)
    stats = {"in": 0, "remapped": 0, "unmapped_kept": 0, "dropped": 0}
    with open(inpath) as f, open(outpath, "w") as o:
        for line in f:
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    continue  # sequence dictionary changes; drop SQ lines
                o.write(line)
                continue
            fields = line.rstrip("\n").split("\t")
            stats["in"] += 1
            if fields[2] == "*":
                o.write(line)
                stats["unmapped_kept"] += 1
                continue
            r = _remap(bed, fields[2], int(fields[3]) - 1)
            if r is None:
                stats["dropped"] += 1
                continue
            fields[2] = r[0]
            fields[3] = str(r[1] + 1)
            o.write("\t".join(fields) + "\n")
            stats["remapped"] += 1
    return stats


def remap_bed(inpath, bedpath, outpath) -> dict:
    bed = BedFile.load(bedpath)
    stats = {"in": 0, "remapped": 0, "dropped": 0}
    with open(inpath) as f, open(outpath, "w") as o:
        for line in f:
            if line.startswith(("track", "#", "browser")) or not line.strip():
                continue
            p = line.rstrip("\n").split("\t")
            stats["in"] += 1
            r = _remap(bed, p[0], int(p[1]))
            if r is None:
                stats["dropped"] += 1
                continue
            ln = int(p[2]) - int(p[1])
            p[0] = r[0]
            p[1] = str(r[1])
            p[2] = str(r[1] + ln)
            o.write("\t".join(p) + "\n")
            stats["remapped"] += 1
    return stats
