"""CLI registration of the port's standalone tools, the commands
kit4b_tpu/cli_tools.py keeps apart from cli.py (flag letters, defaults and
handlers copied from it; it is not imported): the converters and file
tools csvfilter, csvmerge, csv2feat, csv2stats, processcsvfiles,
genhyperdropouts, bedfilter, bedmerge, gfffilter, gtffilter, blast2csv and
psl2csv; the loci statistics loci2dist, gennucstats, genloci2gene,
gencomposition, genrollups, genseqcandidates, genzygosity, fastafilter and
filterreads; the DNA-structure tools genstructprofile, genstructstats,
predconfnucs, dnasitepotential, rnasitepotential, genelementseq,
genelementprofiles, gencentroidmetrics and proccentroids; and the
alignment-block tools loci2core, ref2relloci, genalignstats and
genalignconf. `locmarkers`, which the JAX package registers here, is in
cli.py. Host only: none of them takes a device.
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


def _classifier(args):
    if not getattr(args, "bedfile", None):
        return None
    from .io.biobed import RegionClassifier, load_gene_bed
    return RegionClassifier(load_gene_bed(args.bedfile),
                            getattr(args, "reglen", 2000))


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


def cmd_loci2dist(args) -> int:
    from .tools.locistats import loci2dist, write_loci2dist
    from .utils.runtime import log
    res = loci2dist(_loci_or_bed(args.infile), min_len=args.minlength,
                    max_len=args.maxlength, strand=args.strandproc,
                    classifier=_classifier(args))
    write_loci2dist(args.outfile, res)
    log.info("loci2dist: -> %s", args.outfile)
    return 0


def cmd_gennucstats(args) -> int:
    import json
    from .tools.locistats import gennucstats
    from .utils.runtime import log
    sample = _loci_or_bed(args.sample) if args.sample else None
    res = gennucstats(_loci_or_bed(args.infile), sample,
                      bkg_dyad_ofs=args.bkgdyadofs,
                      smpl_dyad_ofs=args.smpldyadofs,
                      wind_dyad=args.winddyad,
                      classifier=_classifier(args))
    with open(args.outfile, "w") as f:
        json.dump({k: v for k, v in res.items()}, f, indent=1,
                  default=str)
    log.info("gennucstats: %s -> %s",
             {k: v for k, v in res.items() if not isinstance(v, dict)},
             args.outfile)
    return 0


def cmd_genloci2gene(args) -> int:
    from .io.biobed import RegionClassifier, load_gene_bed
    from .tools.locistats import genloci2gene, write_loci2gene
    from .utils.runtime import log
    genes = load_gene_bed(args.locibed)
    cls = RegionClassifier(genes, args.updnstream)
    rows = genloci2gene(_loci_or_bed(args.loci), cls, genes,
                        assoc_dist=args.assocdist,
                        w_intergenic=args.intergenic,
                        w_upstream=args.upstream,
                        w_intragenic=args.intragenic,
                        w_dnstream=args.downstream,
                        clust_dist=args.clustdist, strand=args.strand)
    write_loci2gene(args.outfile, rows)
    log.info("genloci2gene: %d associations -> %s", len(rows),
             args.outfile)
    return 0


def cmd_gencomposition(args) -> int:
    from .io.fasta import Genome
    from .tools.convert import write_quickcount_csv
    from .tools.locistats import gencomposition
    from .utils.runtime import log
    g = Genome.load(args.assembly)
    loci = _loci_or_bed(args.inloci) if args.inloci else None
    res = gencomposition(loci, g, per_seq=args.mode == 1,
                         min_nmer=args.minnmerlen, max_nmer=args.maxnmerlen,
                         min_len=args.minlength, max_len=args.maxlength)
    if args.mode == 1:
        import json
        with open(args.outfile, "w") as f:
            json.dump({n: {k: {m: c for m, c in d.items()}
                           for k, d in v.items()}
                       for n, v in res.items()}, f, indent=1)
    else:
        write_quickcount_csv(args.outfile, res)
    log.info("gencomposition: -> %s", args.outfile)
    return 0


def cmd_genrollups(args) -> int:
    from .tools.locistats import genrollups, write_rollups
    from .utils.runtime import log
    rows = genrollups(_rows_any(args.infile), mode=args.mode,
                      bin_class=args.binclass,
                      percentages=args.percent, region=args.region,
                      align2core=args.align2core,
                      pc_align2core=args.pcalign2core,
                      id_align2core=args.idalign2core,
                      os_identity=args.osidentity)
    write_rollups(args.outfile, rows)
    log.info("genrollups: mode %d -> %s", args.mode, args.outfile)
    return 0


def cmd_genseqcandidates(args) -> int:
    from .index.sfx_index import SfxIndex
    from .tools.locistats import genseqcandidates, write_seqcandidates
    from .utils.runtime import log
    idx = SfxIndex.load(args.sfxfile)
    rows = genseqcandidates(idx, _loci_or_bed(args.infile),
                            subseq_len=args.subseqlen,
                            block_len=args.blockseqlen,
                            min_len=args.minlength,
                            trunc_len=args.truncatelength,
                            ofs=args.offset, delta_len=args.deltalen)
    write_seqcandidates(args.outfile, rows)
    log.info("genseqcandidates: %d blocks -> %s", len(rows), args.outfile)
    return 0


def cmd_genzygosity(args) -> int:
    from .index.sfx_index import SfxIndex
    from .tools.locistats import genzygosity, write_zygosity
    from .utils.runtime import log
    idx = SfxIndex.load(args.sfxfile)
    res = genzygosity(idx, subseq_len=args.subseqlen,
                      max_subs=args.substitutions, max_ns=args.maxns,
                      max_matches=args.maxmatches,
                      threshold=args.zygosity)
    write_zygosity(args.outfile, res, raw_path=args.rawrslts)
    log.info("genzygosity: %d entries -> %s", len(res["names"]),
             args.outfile)
    return 0


def cmd_fastafilter(args) -> int:
    from .tools.locistats import fasta_filter
    from .utils.runtime import log
    st = fasta_filter(args.infile, args.outfile, mode=args.mode,
                      max_n_run=args.maxnrun, sep_unique=args.sepunique)
    log.info("fastafilter: %s -> %s", st, args.outfile)
    return 0


def cmd_filterreads(args) -> int:
    from .io.biobed import RegionClassifier, load_gene_bed
    from .tools.convert import write_loci_csv
    from .tools.locistats import filter_reads_by_region
    from .utils.runtime import log
    genes = []
    for p in args.bedfiles:
        genes.extend(load_gene_bed(p))
    cls = RegionClassifier(genes, args.updnstream)
    kept, dropped = filter_reads_by_region(
        _loci_or_bed(args.infile), cls, regions_in=args.regionsin or "",
        strand=args.strand)
    if args.filtinfile:
        write_loci_csv(args.filtinfile, kept)
    if args.filtoutfile:
        write_loci_csv(args.filtoutfile, dropped)
    log.info("filterreads: %d kept / %d dropped", len(kept), len(dropped))
    return 0


def cmd_genstructprofile(args) -> int:
    from .io.fasta import read_seqs
    from .tools.conformation import load_octamer_params
    from .tools.structextra import genstructprofile
    from .utils.runtime import log
    params = load_octamer_params(args.params)
    rows = genstructprofile(read_seqs(args.infile), params,
                            mode=args.mode, n_samples=args.nsamples,
                            trunc_len=args.truncatelength,
                            ofs_start=args.ofsstart,
                            bkgnd_groove=args.bkgndgroove,
                            dyad_ratio=args.dyadratio,
                            dyad2_ratio=args.dyad2ratio,
                            dyad3_ratio=args.dyad3ratio)
    with open(args.outfile, "w") as f:
        f.write('"Seq","NumDyads","BestPos","BestRatio"\n')
        for r in rows:
            f.write(f'"{r["name"]}",{r["n_dyads"]},{r["best_pos"]},'
                    f'{r["best_ratio"]:.4f}\n')
    log.info("genstructprofile: %d seqs -> %s", len(rows), args.outfile)
    return 0


def cmd_genstructstats(args) -> int:
    from .tools.conformation import load_octamer_params
    from .tools.structextra import genstructstats
    from .utils.runtime import log
    params = load_octamer_params(args.infile)
    n = genstructstats(params, args.outfile, sort_flank=args.sort)
    log.info("genstructstats: %d octamers -> %s", n, args.outfile)
    return 0


def cmd_predconfnucs(args) -> int:
    from .io.bed import BedFile
    from .io.fasta import Genome
    from .tools.conformation import load_octamer_params
    from .tools.structextra import predconfnucs, write_predconfnucs
    from .utils.runtime import log
    g = Genome.load(args.infile)
    params = load_octamer_params(args.conf)
    inc = BedFile.load(args.inclregions) if args.inclregions else None
    peaks = predconfnucs(g, params, dyad_ratio=args.dyadratio,
                         dyad2_ratio=args.dyad2ratio,
                         dyad3_ratio=args.dyad3ratio,
                         mov_avg=args.avgwindow,
                         baseline_win=args.basewindow,
                         include_bed=inc)
    write_predconfnucs(args.outfile, peaks, fmt=args.format,
                       track=args.title)
    n = sum(len(v) for v in peaks.values())
    log.info("predconfnucs: %d nucleosome calls -> %s", n, args.outfile)
    return 0


def cmd_sitepotential(args) -> int:
    from .io.fasta import Genome
    from .tools.structextra import site_potential, write_site_potential
    from .utils.runtime import log
    g = Genome.load(args.genomefile)
    rows = site_potential(_loci_or_bed(args.infile), g,
                          strand=args.strand or "*")
    write_site_potential(args.outfile, rows)
    log.info("sitepotential: %d octamers -> %s", len(rows), args.outfile)
    return 0


def cmd_genelementseq(args) -> int:
    from .io.fasta import Genome
    from .tools.structextra import genelementseq
    from .utils.runtime import log
    g = Genome.load(args.assembly)
    n = genelementseq(_loci_or_bed(args.inloci), g, args.outfile,
                      fmt=args.outformat, min_len=args.minlength,
                      max_len=args.maxlength, classifier=_classifier(args))
    log.info("genelementseq: %d elements -> %s", n, args.outfile)
    return 0


def cmd_genelementprofiles(args) -> int:
    from .io.biobed import load_gene_bed
    from .tools.structextra import (genelementprofiles,
                                    write_element_profiles)
    from .utils.runtime import log
    genes = load_gene_bed(args.features)
    loci = []
    for p in args.infile:
        loci.extend(_loci_or_bed(p))
    res = genelementprofiles(loci, genes, num_bins=args.numbins,
                             feature=args.feature, strand=args.strand,
                             flank_len=args.intergeniclen,
                             profile=args.readprofile)
    write_element_profiles(args.outfile, res)
    log.info("genelementprofiles: %d features -> %s", len(res["genes"]),
             args.outfile)
    return 0


def cmd_gencentroidmetrics(args) -> int:
    from .tools.structextra import gencentroidmetrics, write_centroid_metrics
    from .utils.runtime import log
    if args.mode == 1:
        from .io.fasta import Genome
        res = gencentroidmetrics(None, nmer=args.nmer, mode=1,
                                 genome=Genome.load(args.infile),
                                 overlap=args.overlapnmers)
    else:
        from .io.malign import MAlign
        res = gencentroidmetrics(MAlign.load(args.infile), nmer=args.nmer,
                                 mode=0)
    write_centroid_metrics(args.outfile, res)
    log.info("gencentroidmetrics: mode %d nmer %d -> %s", args.mode,
             args.nmer, args.outfile)
    return 0


def cmd_proccentroids(args) -> int:
    from .tools.structextra import proccentroids
    from .utils.runtime import log
    n = proccentroids(args.infile, args.outfile, nmer=args.nmer,
                      mode=args.mode)
    log.info("proccentroids: %d rows -> %s", n, args.outfile)
    return 0


def cmd_loci2core(args) -> int:
    from .io.malign import MAlign
    from .tools.alignstats import loci2core, write_loci2core
    from .utils.runtime import log
    ma = MAlign.load(args.alignfile)
    rows = loci2core(ma, _loci_or_bed(args.infile),
                     species=args.species.replace(",", " ").split()
                     if args.species else None,
                     min_core_len=args.mincorelen,
                     max_core_len=args.maxcorelen,
                     dist_segs=args.distsegs)
    write_loci2core(args.outfile, rows, args.distsegs)
    log.info("loci2core: %d rows -> %s", len(rows), args.outfile)
    return 0


def cmd_ref2relloci(args) -> int:
    from .io.malign import MAlign
    from .tools.alignstats import ref2relloci, write_ref2relloci
    from .utils.runtime import log
    ma = MAlign.load(args.alignfile)
    rels = args.species.replace(",", " ").split()[1:] if args.species \
        else ma.species[1:]
    loci = _loci_or_bed(args.infile)
    all_rows = []
    for rel in rels:
        all_rows.extend(ref2relloci(ma, loci, rel_species=rel,
                                    min_len=args.minlen,
                                    max_len=args.maxlen))
    write_ref2relloci(args.outfile, all_rows)
    log.info("ref2relloci: %d mapped -> %s", len(all_rows), args.outfile)
    return 0


def cmd_genalignstats(args) -> int:
    from .io.malign import MAlign
    from .tools.alignstats import genalignstats, write_alignstats
    from .utils.runtime import log
    ma = MAlign.load(args.infile)
    res = genalignstats(ma, mode=args.mode,
                        species=args.species.replace(",", " ").split()
                        if args.species else None,
                        min_species=args.minspecies)
    write_alignstats(args.outfile, res)
    log.info("genalignstats: %.2f%% identity -> %s", res["identity_pct"],
             args.outfile)
    return 0


def cmd_genalignconf(args) -> int:
    from .io.malign import MAlign
    from .tools.alignstats import genalignconf, write_alignconf
    from .utils.runtime import log
    ma = MAlign.load(args.infile)
    rows = genalignconf(ma, mode=args.mode, per_chrom=args.chromper,
                        min_species=args.minspecies,
                        max_species=args.maxspecies,
                        min_block_len=args.minblocklen,
                        max_block_len=args.maxblocklen,
                        chrom=args.chrom)
    write_alignconf(args.outfile, rows)
    log.info("genalignconf: %d scopes -> %s", len(rows), args.outfile)
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

    p = sub.add_parser("loci2dist", help="element length distributions")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--strandproc", type=int, default=0)
    p.add_argument("-i", "--incsv", dest="infile", required=True)
    p.add_argument("-I", "--inbed", dest="bedfile", default=None)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    p.add_argument("-r", "--updnstream", dest="reglen", type=int,
                   default=2000)
    p.add_argument("-l", "--minlength", type=int, default=1)
    p.add_argument("-L", "--maxlength", type=int, default=500)
    common(p)
    p.set_defaults(fn=cmd_loci2dist)

    p = sub.add_parser("gennucstats", help="dyad loci distributions")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-b", "--bkgdyadofs", type=int, default=73)
    p.add_argument("-s", "--smpldyadofs", type=int, default=73)
    p.add_argument("--winddyad", type=int, default=5)
    p.add_argument("-i", "--infile", required=True)
    p.add_argument("-I", "--sample", default=None)
    p.add_argument("-o", "--outfile", required=True)
    p.add_argument("-B", "--bed", dest="bedfile", default=None)
    p.add_argument("-r", "--updnstream", dest="reglen", type=int,
                   default=2000)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_gennucstats)

    p = sub.add_parser("genloci2gene", help="associate loci to genes")
    p.add_argument("-m", "--procmode", dest="mode", type=int, default=0)
    p.add_argument("-L", "--updnstream", type=int, default=2000)
    p.add_argument("-a", "--assocdist", type=int, default=100000)
    p.add_argument("--intergenic", type=int, default=1)
    p.add_argument("-x", "--upstream", type=int, default=4)
    p.add_argument("-y", "--intragenic", type=int, default=5)
    p.add_argument("-z", "--downstream", type=int, default=3)
    p.add_argument("-c", "--clustdist", type=int, default=0)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-b", "--locibed", required=True)
    p.add_argument("-i", "--loci", required=True)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_genloci2gene)

    p = sub.add_parser("gencomposition", help="N-mer composition of loci")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-i", "--inloci", default=None)
    p.add_argument("-I", "--assembly", required=True)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    p.add_argument("-l", "--minlength", type=int, default=10)
    p.add_argument("-L", "--maxlength", type=int, default=10 ** 9)
    p.add_argument("-k", "--minnmerlen", type=int, default=1)
    p.add_argument("-K", "--maxnmerlen", type=int, default=5)
    common(p)
    p.set_defaults(fn=cmd_gencomposition)

    p = sub.add_parser("genrollups", help="length-range rollup stats")
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-r", "--region", type=int, default=7)
    p.add_argument("-p", "--percent", action="store_true")
    p.add_argument("-c", "--binclass", type=int, default=0)
    p.add_argument("-a", "--align2core", type=int, default=1)
    p.add_argument("-P", "--pcalign2core", type=float, default=0.0)
    p.add_argument("-A", "--idalign2core", type=float, default=0.0)
    p.add_argument("-k", "--osidentity", type=float, default=0.0)
    common(p)
    p.set_defaults(fn=cmd_genrollups)

    p = sub.add_parser("genseqcandidates",
                       help="candidate blocks with uniqueness counts")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--subseqlen", type=int, default=25)
    p.add_argument("-b", "--blockseqlen", type=int, default=1000)
    p.add_argument("-l", "--minlength", type=int, default=147)
    p.add_argument("-T", "--truncatelength", type=int, default=147)
    p.add_argument("-u", "--offset", type=int, default=0)
    p.add_argument("-U", "--deltalen", type=int, default=0)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-I", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _chromres(p)
    common(p)
    p.set_defaults(fn=cmd_genseqcandidates)

    p = sub.add_parser("genzygosity", help="chrom zygosity matrix")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-z", "--zygosity", type=float, default=0.25)
    p.add_argument("-i", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-O", "--rawrslts", default=None)
    p.add_argument("-l", "--subseqlen", type=int, default=25)
    p.add_argument("-s", "--substitutions", type=int, default=2)
    p.add_argument("-n", "--maxns", type=int, default=1)
    p.add_argument("-x", "--maxmatches", type=int, default=5000)
    common(p)
    p.set_defaults(fn=cmd_genzygosity)

    p = sub.add_parser("fastafilter", help="N-run/duplicate-id filter")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-n", "--maxnrun", type=int, default=10)
    p.add_argument("-s", "--sepunique", default=".")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_fastafilter)

    p = sub.add_parser("filterreads", help="filter reads by region")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--filtinfile", default=None)
    p.add_argument("-O", "--filtoutfile", default=None)
    p.add_argument("-L", "--updnstream", type=int, default=2000)
    p.add_argument("-r", "--regionsin", default="")
    p.add_argument("-I", "--bedfiles", action="append", default=[])
    common(p)
    p.set_defaults(fn=cmd_filterreads)

    p = sub.add_parser("genstructprofile",
                       help="dyad detection over fasta")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-n", "--nsamples", type=int, default=0)
    p.add_argument("-T", "--truncatelength", type=int, default=300)
    p.add_argument("-u", "--ofsstart", type=int, default=0)
    p.add_argument("-b", "--bkgndgroove", type=float, default=11.12)
    p.add_argument("-d", "--dyadratio", type=float, default=1.030)
    p.add_argument("-D", "--dyad2ratio", type=float, default=1.020)
    p.add_argument("-e", "--dyad3ratio", type=float, default=1.015)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-p", "--params", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_genstructprofile)

    p = sub.add_parser("genstructstats",
                       help="octamer parameter table report")
    p.add_argument("-s", "--sort", action="store_true")
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_genstructstats)

    p = sub.add_parser("predconfnucs",
                       help="conformation nucleosome prediction")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-I", "--conf", required=True)
    p.add_argument("-r", "--inclregions", default=None)
    p.add_argument("-d", "--dyadratio", type=float, default=1.020)
    p.add_argument("-D", "--dyad2ratio", type=float, default=1.015)
    p.add_argument("-e", "--dyad3ratio", type=float, default=1.010)
    p.add_argument("-a", "--avgwindow", type=int, default=10)
    p.add_argument("-A", "--basewindow", type=int, default=250)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-M", "--format", type=int, default=0)
    p.add_argument("-t", "--title", default="nucs")
    common(p)
    p.set_defaults(fn=cmd_predconfnucs)

    for name in ("dnasitepotential", "rnasitepotential"):
        p = sub.add_parser(name, help="read start site potentials")
        p.add_argument("-m", "--mode", type=int, default=0)
        p.add_argument("-s", "--strand", default="*")
        p.add_argument("-i", "--in", dest="infile", required=True)
        p.add_argument("-I", "--genome", dest="genomefile", required=True)
        p.add_argument("-o", "--out", dest="outfile", required=True)
        common(p)
        p.set_defaults(fn=cmd_sitepotential)

    p = sub.add_parser("genelementseq", help="element sequence extraction")
    p.add_argument("-c", "--informat", type=int, default=0)
    p.add_argument("-i", "--inloci", required=True)
    p.add_argument("-I", "--inbed", dest="bedfile", default=None)
    p.add_argument("-a", "--assembly", required=True)
    p.add_argument("-o", "--output", dest="outfile", required=True)
    p.add_argument("-p", "--outformat", type=int, default=0)
    p.add_argument("-m", "--minlength", type=int, default=0)
    p.add_argument("-M", "--maxlength", type=int, default=1_000_000)
    p.add_argument("-L", "--updnstream", dest="reglen", type=int,
                   default=2000)
    common(p)
    p.set_defaults(fn=cmd_genelementseq)

    p = sub.add_parser("genelementprofiles",
                       help="binned read profiles over features")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-P", "--readprofile", type=int, default=0)
    p.add_argument("-s", "--strand", type=int, default=0)
    p.add_argument("-l", "--intergeniclen", type=int, default=1000)
    p.add_argument("-n", "--numbins", type=int, default=100)
    p.add_argument("-r", "--feature", type=int, default=0)
    p.add_argument("-i", "--in", dest="infile", action="append",
                   required=True)
    p.add_argument("-I", "--features", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_genelementprofiles)

    p = sub.add_parser("gencentroidmetrics",
                       help="centroid N-mer counts")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-n", "--nmer", type=int, default=5)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-z", "--overlapnmers", action="store_true")
    common(p)
    p.set_defaults(fn=cmd_gencentroidmetrics)

    p = sub.add_parser("proccentroids",
                       help="centroid count statistics")
    p.add_argument("-n", "--nmer", type=int, default=5)
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    common(p)
    p.set_defaults(fn=cmd_proccentroids)

    p = sub.add_parser("loci2core", help="map loci onto multialignment")
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-I", dest="alignfile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-s", "--species", default="")
    p.add_argument("-m", "--mincorelen", type=int, default=20)
    p.add_argument("-M", "--maxcorelen", type=int, default=1_000_000)
    p.add_argument("-d", "--distsegs", type=int, default=10)
    common(p)
    p.set_defaults(fn=cmd_loci2core)

    p = sub.add_parser("ref2relloci",
                       help="project ref loci into rel species coords")
    p.add_argument("-m", "--procmode", dest="mode", type=int, default=0)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-I", dest="alignfile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-s", "--species", default="")
    p.add_argument("-l", "--minlen", type=int, default=20)
    p.add_argument("-L", "--maxlen", type=int, default=100_000_000)
    common(p)
    p.set_defaults(fn=cmd_ref2relloci)

    p = sub.add_parser("genalignstats", help="multialignment statistics")
    p.add_argument("-m", "--procmode", dest="mode", type=int, default=0)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-s", "--species", default="")
    p.add_argument("-M", "--minspecies", type=int, default=2)
    common(p)
    p.set_defaults(fn=cmd_genalignstats)

    p = sub.add_parser("genalignconf", help="alignment conformance stats")
    p.add_argument("-m", "--procmode", dest="mode", type=int, default=0)
    p.add_argument("-i", dest="infile", required=True)
    p.add_argument("-o", dest="outfile", required=True)
    p.add_argument("-c", "--chromper", action="store_true")
    p.add_argument("-C", "--chrom", default=None)
    p.add_argument("-z", "--minspecies", type=int, default=2)
    p.add_argument("-Z", "--maxspecies", type=int, default=50)
    p.add_argument("-x", "--minblocklen", type=int, default=0)
    p.add_argument("-X", "--maxblocklen", type=int, default=1 << 40)
    common(p)
    p.set_defaults(fn=cmd_genalignconf)
