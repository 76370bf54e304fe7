"""CLI registration of the port's standalone converter and file tools,
the commands kit4b_tpu/cli_tools.py keeps apart from cli.py (flag letters
and defaults copied from it; it is not imported): csvfilter, csvmerge,
csv2feat, csv2stats, processcsvfiles, genhyperdropouts, bedfilter,
bedmerge, gfffilter, gtffilter, blast2csv and psl2csv. Host only: none of
them takes a device.
"""
from __future__ import annotations


def _loci_or_bed(path) -> list[dict]:
    """Read loci rows from a loci CSV or a BED file (tools accepting
    either, e.g. loci2dist -m)."""
    p = str(path)
    head = open(p).read(2048)
    first = head.splitlines()[0] if head else ""
    if "\t" in first or p.endswith(".bed"):
        from .io.bed import BedFile
        out = []
        for i, ft in enumerate(BedFile.load(p).features):
            out.append({"srcid": i + 1, "type": "el", "species": "",
                        "chrom": ft.chrom, "start": ft.start,
                        "end": ft.end - 1, "len": ft.end - ft.start,
                        "strand": ft.strand or "+"})
        return out
    from .tools.convert import read_loci_csv
    rows = read_loci_csv(p)
    if rows:
        return rows
    from .tools.csvtools import read_outspecies_csv
    return read_outspecies_csv(p)


def _rows_any(path) -> list[dict]:
    """Read outspecies rows when present, falling back to plain loci."""
    from .tools.convert import read_loci_csv
    from .tools.csvtools import read_outspecies_csv
    rows = read_outspecies_csv(path)
    return rows if rows else read_loci_csv(path)


# ------------------------------------------------------------------- cmds

def cmd_csvfilter(args) -> int:
    from .tools.convert import write_loci_csv
    from .tools.csvtools import csv_filter, write_outspecies_csv
    from .utils.runtime import log
    rows = _rows_any(args.infile)
    kept = csv_filter(
        rows, min_len=args.minlen, max_len=args.maxlen,
        regions_in=args.regionsin or "", regions_out=args.regionsout or "",
        species_in=args.species.split(",") if args.species else None,
        exclude_refids=_refids(args.xfile), include_refids=_refids(args.ifile),
        exclude_loci=args.exclude or None, include_loci=args.include or None,
        chrom_exclude=args.chromexclude or None,
        chrom_include=args.chrominclude or None,
        overlaps=args.nooverlaps, no_overlaps=args.overlaps,
        align2core=args.align2core, pc_align2core=args.pcalign2core,
        id_ident2core=args.identcore, os_identity=args.osidentity,
        select_n=args.selectn)
    if kept and "matches" in kept[0]:
        write_outspecies_csv(args.outfile, kept)
    else:
        write_loci_csv(args.outfile, kept)
    log.info("csvfilter: %d -> %d rows -> %s", len(rows), len(kept),
             args.outfile)
    return 0


def _refids(path) -> set | None:
    if not path:
        return None
    ids = set()
    with open(path) as f:
        for line in f:
            tok = line.split(",")[0].strip().strip('"')
            if tok.isdigit():
                ids.add(int(tok))
    return ids


def cmd_csvmerge(args) -> int:
    from .tools.convert import read_loci_csv, write_loci_csv
    from .tools.csvtools import csv_merge
    from .utils.runtime import log
    ref = read_loci_csv(args.reffile)
    rel = read_loci_csv(args.relfile) if args.relfile else []
    merged = csv_merge(
        ref, rel, mode=args.mode, min_len=args.minlength,
        max_len=args.maxlength, min_merge_len=args.minmergelength,
        max_merge_len=args.maxmergelength, ref_extend=args.refextend,
        rel_extend=args.relextend, join_distance=args.join,
        ref_species=args.refspecies, rel_species=args.relspecies,
        el_type=args.eltype)
    write_loci_csv(args.outfile, merged)
    log.info("csvmerge: mode %d, %d+%d -> %d -> %s", args.mode,
             len(ref), len(rel), len(merged), args.outfile)
    return 0


def cmd_csv2feat(args) -> int:
    from .io.bed import BedFile
    from .tools.csvtools import csv2feat, write_csv2feat
    from .utils.runtime import log
    loci = _loci_or_bed(args.inloci)
    rows = csv2feat(loci, BedFile.load(args.feat), min_len=args.minlength,
                    max_len=args.maxlength, min_overlap=args.minoverlap)
    write_csv2feat(args.outfile, rows)
    log.info("csv2feat: %d mappings -> %s", len(rows), args.outfile)
    return 0


def cmd_csv2stats(args) -> int:
    from .io.fasta import Genome
    from .tools.csvtools import csv2stats, write_csv2stats
    from .utils.runtime import log
    g = Genome.load(args.assembly)
    rows = csv2stats(_loci_or_bed(args.inloci), g, min_len=args.minlength,
                     max_len=args.maxlength)
    write_csv2stats(args.outfile, rows)
    log.info("csv2stats: %d rows -> %s", len(rows), args.outfile)
    return 0


def cmd_processcsvfiles(args) -> int:
    import glob as _glob
    from .tools.csvtools import (process_csv_files, read_outspecies_csv,
                                 write_process_csv)
    from .utils.runtime import log
    ref = _rows_any(args.reffile)
    rel_sets = {}
    for pat in args.relfile:
        for p in sorted(_glob.glob(pat)) or [pat]:
            rel_sets[p] = read_outspecies_csv(p)
    rows = process_csv_files(ref, rel_sets, mode=args.mode,
                             min_len=args.minlen, max_len=args.maxlen,
                             exclude_refids=_refids(args.xfile))
    write_process_csv(args.outfile, rows, sorted(rel_sets))
    log.info("processcsvfiles: %d rows x %d files -> %s", len(rows),
             len(rel_sets), args.outfile)
    return 0


def cmd_genhyperdropouts(args) -> int:
    from .tools.convert import read_loci_csv, write_loci_csv
    from .tools.csvtools import hyper_dropouts
    from .utils.runtime import log
    ref = read_loci_csv(args.reffile)
    rel = read_loci_csv(args.relfile)
    rows = hyper_dropouts(ref, rel, mode=args.mode,
                          overlap_bases=args.overlapbases,
                          overlap_pct=args.minpercent,
                          min_len=args.minlength, max_len=args.maxlength,
                          join_overlap=args.joinoverlap)
    if args.outloci:
        write_loci_csv(args.outloci, rows)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write('"Class","Count"\n')
            from collections import Counter
            for k, v in sorted(Counter(r["class"] for r in rows).items()):
                f.write(f'"{k}",{v}\n')
    log.info("genhyperdropouts: mode %d -> %d rows", args.mode, len(rows))
    return 0


def cmd_bedfilter(args) -> int:
    from .tools.bedtools2 import bed_filter
    from .utils.runtime import log
    n = bed_filter(args.infile, args.outfile, strand=args.strand,
                   min_len=args.minlen, max_len=args.maxlen,
                   chrom_exclude=args.chromexclude or None,
                   chrom_include=args.chrominclude or None)
    log.info("bedfilter: %d features -> %s", n, args.outfile)
    return 0


def cmd_bedmerge(args) -> int:
    import glob as _glob
    from .tools.bedtools2 import bed_merge
    from .utils.runtime import log
    paths = [p for pat in args.srcfiles
             for p in (sorted(_glob.glob(pat)) or [pat])]
    n = bed_merge(paths, args.outfile, mode=args.mode, strand=args.strand,
                  region=args.genomicregion, min_len=args.minlen,
                  join_len=args.joinlen,
                  chrom_exclude=args.chromexclude or None,
                  chrom_include=args.chrominclude or None,
                  gene_bed=args.bedfile, reg_len=args.reglen)
    log.info("bedmerge: %d merged features -> %s", n, args.outfile)
    return 0


def cmd_gfffilter(args) -> int:
    from .tools.bedtools2 import gff_filter
    from .utils.runtime import log
    n = gff_filter(args.infile, args.outfile, mode=args.mode,
                   genes=args.genes, name_attr=args.name,
                   scale=args.scale)
    log.info("gfffilter: %d records -> %s", n, args.outfile)
    return 0


def cmd_gtffilter(args) -> int:
    from .tools.bedtools2 import gtf_filter
    from .utils.runtime import log
    n = gtf_filter(args.infile, args.outfile, map_path=args.mapfile)
    log.info("gtffilter: %d records -> %s", n, args.outfile)
    return 0


def cmd_blast2csv(args) -> int:
    from .tools.blastpsl import blast2csv
    from .utils.runtime import log
    n = blast2csv(args.infile, args.outfile,
                  chrom_exclude=args.chromexclude or None,
                  chrom_include=args.chrominclude or None)
    log.info("blast2csv: %d alignments -> %s", n, args.outfile)
    return 0


def cmd_psl2csv(args) -> int:
    from .tools.blastpsl import psl2csv
    from .utils.runtime import log
    n = psl2csv(args.infile, args.outfile,
                chrom_exclude=args.chromexclude or None,
                chrom_include=args.chrominclude or None)
    log.info("psl2csv: %d alignments -> %s", n, args.outfile)
    return 0


# -------------------------------------------------------------- registry

def register(sub, common) -> None:
    def _chromres(p):
        p.add_argument("-Z", "--chromexclude", action="append", default=[])
        p.add_argument("-z", "--chrominclude", action="append", default=[])

    p = sub.add_parser("csvfilter", help="filter loci/outspecies CSV")
    p.add_argument("-m", "--procmode", dest="mode", type=int, default=0)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-R", "--regionsout", default="")
    p.add_argument("-r", "--regionsin", default="")
    p.add_argument("-s", "--includespecies", dest="species", default="")
    p.add_argument("-j", "--nooverlaps", action="store_true")
    p.add_argument("-J", "--overlaps", action="store_true")
    p.add_argument("-X", dest="xfile", default=None)
    p.add_argument("-x", dest="ifile", default=None)
    p.add_argument("-l", "--minlen", type=int, default=0)
    p.add_argument("-L", "--maxlen", type=int, default=0)
    p.add_argument("-a", "--align2core", type=int, default=0)
    p.add_argument("-P", "--pcalign2core", type=float, default=0.0)
    p.add_argument("-A", "--identcore", type=float, default=0.0)
    p.add_argument("-k", "--osidentity", type=float, default=0.0)
    p.add_argument("-E", "--exclude", action="append", default=[])
    p.add_argument("-I", "--include", action="append", default=[])
    p.add_argument("-N", "--selectn", type=int, default=0)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_csvfilter)

    p = sub.add_parser("csvmerge", help="set-merge ref/rel loci CSVs")
    p.add_argument("-i", "--reffile", required=True)
    p.add_argument("-I", "--relfile", default=None)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-r", "--refspecies", default="ref")
    p.add_argument("-R", "--relspecies", default="rel")
    p.add_argument("-t", "--eltype", default="el")
    p.add_argument("-p", "--mode", type=int, default=3)
    p.add_argument("-l", "--minlength", type=int, default=4)
    p.add_argument("-L", "--maxlength", type=int, default=1_000_000)
    p.add_argument("-m", "--minmergelength", type=int, default=4)
    p.add_argument("-M", "--maxmergelength", type=int, default=1_000_000)
    p.add_argument("-e", "--refextend", type=int, default=0)
    p.add_argument("-E", "--relextend", type=int, default=0)
    p.add_argument("-j", "--join", type=int, default=0)
    common(p)
    p.set_defaults(fn=cmd_csvmerge)

    p = sub.add_parser("csv2feat", help="map elements onto BED features")
    p.add_argument("-i", "--inloci", required=True)
    p.add_argument("-I", "--feat", required=True)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    p.add_argument("-l", "--minlength", type=int, default=4)
    p.add_argument("-L", "--maxlength", type=int, default=10 ** 9)
    p.add_argument("-M", "--minoverlap", type=int, default=1)
    common(p)
    p.set_defaults(fn=cmd_csv2feat)

    p = sub.add_parser("csv2stats", help="element composition stats")
    p.add_argument("-i", "--inloci", required=True)
    p.add_argument("-I", "--assembly", required=True)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    p.add_argument("-l", "--minlength", type=int, default=10)
    p.add_argument("-L", "--maxlength", type=int, default=10 ** 9)
    common(p)
    p.set_defaults(fn=cmd_csv2stats)

    p = sub.add_parser("processcsvfiles",
                       help="identity rollups ref vs rel CSVs")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-i", "--in", dest="reffile", required=True)
    p.add_argument("-I", "--rel", dest="relfile", action="append",
                   required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-X", dest="xfile", default=None)
    p.add_argument("-l", "--minlen", type=int, default=0)
    p.add_argument("-L", "--maxlen", type=int, default=10 ** 9)
    common(p)
    p.set_defaults(fn=cmd_processcsvfiles)

    p = sub.add_parser("genhyperdropouts",
                       help="hyper element dropout classification")
    p.add_argument("-i", "--reffile", required=True)
    p.add_argument("-I", "--relfile", required=True)
    p.add_argument("-o", dest="outfile", default=None)
    p.add_argument("-O", dest="outloci", default=None)
    p.add_argument("-r", "--refspecies", default="ref")
    p.add_argument("-R", "--relspecies", default="rel")
    p.add_argument("-t", "--eltype", default="el")
    p.add_argument("-p", "--mode", type=int, default=0)
    p.add_argument("-l", "--overlapbases", type=int, default=10)
    p.add_argument("-L", "--minpercent", type=int, default=50)
    p.add_argument("-m", "--minlength", type=int, default=0)
    p.add_argument("-M", "--maxlength", type=int, default=1_000_000)
    p.add_argument("-j", "--joinoverlap", type=int, default=4)
    common(p)
    p.set_defaults(fn=cmd_genhyperdropouts)

    p = sub.add_parser("bedfilter", help="filter BED features")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-l", "--minlen", type=int, default=1)
    p.add_argument("-L", "--maxlen", type=int, default=20)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile", required=True)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_bedfilter)

    p = sub.add_parser("bedmerge", help="merge features across BED files")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-r", "--genomicregion", type=int, default=0)
    p.add_argument("-l", "--minlen", type=int, default=20)
    p.add_argument("-j", "--joinlen", type=int, default=1)
    p.add_argument("-i", "--srcfiles", action="append", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-b", "--bed", dest="bedfile", default=None,
                   help="gene BED for -r region retention")
    p.add_argument("-L", "--updnstream", dest="reglen", type=int,
                   default=2000)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_bedmerge)

    p = sub.add_parser("gfffilter", help="filter GFF3 by gene class")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-g", "--genes", type=int, default=1)
    p.add_argument("-n", "--name", default="Name")
    p.add_argument("-s", "--scale", type=float, default=1.0)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_gfffilter)

    p = sub.add_parser("gtffilter", help="normalise/remap GTF")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-I", "--map", dest="mapfile", default=None)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_gtffilter)

    p = sub.add_parser("blast2csv", help="BLAST -m8/9 tabular to CSV")
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile", required=True)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_blast2csv)

    p = sub.add_parser("psl2csv", help="UCSC PSL to CSV")
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-o", "--outfile", required=True)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_psl2csv)
