"""GFF3 / GTF parsing (CGFFFile / CGTFFile parity), the port's copy of
kit4b_tpu/io/gff.py (host only; tests/test_torch_rehomed.py holds it equal
to the original statement for statement).

Both formats parse into one record type; `to_bed` bridges into the
interval-query layer.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class GffRecord:
    seqid: str
    source: str
    ftype: str
    start: int        # 1-based inclusive (native GFF coords)
    end: int          # inclusive
    score: float | None
    strand: str
    phase: str
    attrs: dict = field(default_factory=dict)


def _parse_attrs_gff3(s: str) -> dict:
    out = {}
    for part in s.split(";"):
        part = part.strip()
        if not part or "=" not in part:
            continue
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out


def _parse_attrs_gtf(s: str) -> dict:
    out = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        if " " in part:
            k, v = part.split(" ", 1)
            out[k.strip()] = v.strip().strip('"')
    return out


def read_gff(path, gtf: bool | None = None):
    """Yield GffRecord; format auto-detected from the attribute column when
    `gtf` is None."""
    parse_attrs = None
    if gtf is True:
        parse_attrs = _parse_attrs_gtf
    elif gtf is False:
        parse_attrs = _parse_attrs_gff3
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            c = line.split("\t")
            if len(c) < 8:
                continue
            attr_str = c[8] if len(c) > 8 else ""
            if parse_attrs is None:
                parse_attrs = (_parse_attrs_gtf if '"' in attr_str
                               else _parse_attrs_gff3)
            yield GffRecord(
                c[0], c[1], c[2], int(c[3]), int(c[4]),
                None if c[5] in (".", "") else float(c[5]),
                c[6], c[7], parse_attrs(attr_str))


def to_bed(records, ftype: str | None = None,
           name_attr: str = "ID"):
    """GFF records -> BedFile (0-based half-open), optionally filtered by
    feature type; name taken from `name_attr` (ID / gene_id / ...)."""
    from .bed import BedFeature, BedFile
    feats = []
    for r in records:
        if ftype and r.ftype != ftype:
            continue
        name = r.attrs.get(name_attr) or r.attrs.get("gene_id") or r.ftype
        feats.append(BedFeature(r.seqid, r.start - 1, r.end, name,
                                int(r.score or 0), r.strand))
    return BedFile(feats)
