"""Command-line entry of the PyTorch/CUDA port: `python -m kit4b_tpu_torch`.

Port of kit4b_tpu/cli.py with the `index`, `simreads`, `kalign` (single
and paired ends), `hammings`, `pseudogenome`, `kmarkers` and `prekmarkers`
subcommands, taking the same flags and writing the same files, plus
`--device {cuda,cpu}` on the commands that use a device (`kalign`,
`hammings`, `kmarkers`). The
parsers are copies, as is all the port needs of the JAX package: it
imports none of it. Flags of paths not ported yet parse as in kit4b_tpu and raise
NotImplementedError naming their ROADMAP item.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .device import DeviceUnavailable, resolve
from .index.sfx_index import SfxIndex
from .io.fasta import Genome, read_seqs
from .native import NativeUnavailable
from .utils.runtime import PhaseTimer, log, setup_logging


def _common(p: argparse.ArgumentParser) -> None:
    p.add_argument("-F", "--log", dest="logfile", default=None,
                   help="diagnostics log file")
    p.add_argument("-f", "--loglevel", dest="loglevel", default="info",
                   help="log level (none|info|debug)")
    p.add_argument("-q", "--sumrslts", dest="sumrslts", default=None,
                   help="SQLite experiment-summaries DB")
    p.add_argument("-w", "--experimentname", dest="experimentname",
                   default="exp")
    p.add_argument("-W", "--experimentdescr", dest="experimentdescr",
                   default="")


def cmd_index(args) -> int:
    """ngskit4b index equivalent (kit4bax.cpp:73 kingsax), standard mode:
    SA-IS + bucket LUT on the port's host library, written as a .kix that
    either package loads."""
    if args.mode != 0:
        raise NotImplementedError("index -m 1 (bisulfite) is not ported "
                                  "yet: ROADMAP.md queue A item 17")
    t = PhaseTimer()
    with t.phase("load genome"):
        g = Genome.load(*args.infile)
    with t.phase("build suffix index"):
        idx = SfxIndex.build(g)
    with t.phase("write index"):
        idx.save(args.outfile)
    log.info("index: %d seqs, %d bp, lut_k=%d, %d clean suffixes -> %s",
             g.nchroms(), g.total_len, idx.lut_k, len(idx.sa_clean),
             args.outfile)
    return 0


# kalign flags of paths not ported yet, each off by default:
# dest -> (flag, ROADMAP queue A item)
_KALIGN_UNPORTED = {
    "mlmode": ("--mlmode", 20),
    "bisulfite": ("--bisulfite", 17), "csindex": ("--csindex (BAM)", 20),
    "baindex": ("--baindex (BAM)", 20), "include": ("-Z", 20),
    "exclude": ("-z", 20), "priobed": ("-B", 20), "pcrdups": ("-5", 20),
    "wigfile": ("-g", 20), "nonealign": ("--nonealign", 20),
    "multialign": ("--multialign", 20), "markerfile": ("--markerfile", 20),
    "snpcentroidfile": ("--snpcentroidfile", 20), "pbafile": ("-3", 20),
    "disnpfile": ("-X", 20), "minflankexacts": ("-x", 20),
    "pcrprimersubs": ("-6", 20), "lociconstraints": ("--lociconstraints", 20),
}


def cmd_simreads(args) -> int:
    """ngskit4b simreads equivalent (libkit4b/SimReads.cpp: GenSimReads
    :1805, SimSeqErrors :272, SimInDels :137, SimArtefacts :174,
    SimulateSNPs :1222; flags ngskit4b/SimReads.cpp:149-200). Host only."""
    from .sim import simreads
    g = Genome.load(args.infile)
    regions = None
    if args.featfile:
        from .io.bed import BedFile
        bed = BedFile.load(args.featfile)
        regions = [(f.chrom, f.start, f.end) for f in bed.features]
    if args.snprate:
        g, snp_truth = simreads.simulate_snps(
            g, rate=args.snprate / 1e6, seed=args.seed)
        if args.outsnp:
            simreads.write_snp_bed(args.outsnp, snp_truth)
    params = simreads.SimParams(
        n_reads=args.nreads, read_len=args.length,
        pe=args.pe is not None,
        pe_insert_min=args.insertmin, pe_insert_max=args.insertmax,
        error_mode=args.errmode, subs_rate=args.subsrate,
        uniform_profile=args.seqerrprofile,
        strand=("watson" if args.strand == "+" else "both"),
        seed=args.seed,
        indel_rate=args.indelrate, indel_size=args.indelsize,
        artef5_rate=args.artif5rate, artef3_rate=args.artif3rate,
        artef5_seqs=tuple(args.artif5str) if args.artif5str
        else (simreads.DEFAULT_ARTEF5,),
        artef3_seqs=tuple(args.artif3str) if args.artif3str
        else (simreads.DEFAULT_ARTEF3,),
        rand_reads=args.randreads, regions=regions,
        dedupe=args.dedupe)
    out = simreads.sim_reads(g, params)
    fmt = "fastq" if args.fastq else "fasta"
    if params.pe:
        r1, r2 = out
        simreads.write_reads(args.outfile, r1, fmt)
        simreads.write_reads(args.outpe, r2, fmt)
        print(f"simreads: wrote {len(r1)} pairs")
    else:
        simreads.write_reads(args.outfile, out, fmt)
        print(f"simreads: wrote {len(out)} reads")
    return 0


def cmd_kalign(args) -> int:
    """ngskit4b kalign equivalent (KAlignerCL.cpp / KAligner.cpp): single
    ends, with the microInDel (-y), splice (-l) and chimeric (-C) rescues
    on request, or paired ends with -u (pairing, the deep tier and the
    insert-window rescue, align.pe). Plain single ends and paired ends
    write SAM through the native formatters; a rescue route writes it
    record by record, after the orphan junction removal."""
    from .align import kalign
    for dest, (flag, item) in _KALIGN_UNPORTED.items():
        if getattr(args, dest):
            raise NotImplementedError(f"kalign {flag} is not ported yet: "
                                      f"ROADMAP.md queue A item {item}")
    if args.outfile.endswith(".bam"):
        raise NotImplementedError("kalign BAM output is not ported yet: "
                                  "ROADMAP.md queue A item 20")
    device = resolve(args.device)
    t = PhaseTimer()
    with t.phase("load index"):
        idx = SfxIndex.load(args.sfxfile)
    sens = {0: "default", 1: "more", 2: "ultra", 3: "less"}[args.mode]
    al = kalign.KAligner(idx, max_subs=args.substitutions,
                         mm_delta=args.editdelta, max_ml=args.maxmulti,
                         max_ns=args.maxns, batch_size=args.batchsize,
                         sens=sens, micro_indel=args.microindellen,
                         splice_max=args.splicemax,
                         chimeric_pct=args.chimeric, device=device)
    caller = None
    if args.snpfile:
        from .align import snp     # imports scipy: only for -S
        caller = snp.SnpCaller(idx.genome, snp.SnpOptions(
            min_snp_reads=args.minsnpreads, qvalue=args.qvalue))

    def stream(paths):
        for path in paths:
            yield from read_seqs(path)

    if args.pairfile:  # paired-end mode (-U/-u/-d/-D)
        from .align import pe
        pal = pe.PeAligner(al, pair_min_len=args.pairminlen,
                           pair_max_len=args.pairmaxlen,
                           pe_mode=args.pemode or 2)
        with t.phase("align"):
            stats = pal.write_sam_fast(
                args.outfile,
                pal.align_pairs(list(stream(args.infile)),
                                list(stream(args.pairfile))),
                cmdline=" ".join(sys.argv),
                emit_unmapped=(args.format == 1), snp_caller=caller)
        log.info("kalign PE: %s; pair rows by stage %s on %s", stats,
                 pal.stage_rows, device)
    elif al._use_compact():
        src = args.infile[0] if len(args.infile) == 1 \
            else stream(args.infile)
        with t.phase("align"):
            stats = kalign.write_sam_fast(
                args.outfile, idx, al, src, cmdline=" ".join(sys.argv),
                emit_unmapped=(args.format == 1), snp_caller=caller,
                stats_path=args.statsfile)
        log.info("kalign: %d reads, %s; tier 1 by read length %s on %s",
                 sum(stats.values()), stats,
                 {L: "v5" if v5 else "v4"
                  for L, v5 in al._lut4_decided.items()}, device)
    else:
        from .align import phases
        with t.phase("align"):
            aligned = list(al.align_records(stream(args.infile)))
            # orphan junction removal (KAligner.cpp:668/:680)
            if args.splicemax:
                n = phases.remove_orphan_junctions(aligned, "splice")
                log.info("kalign: %d orphan splice junctions removed", n)
            if args.microindellen:
                n = phases.remove_orphan_junctions(aligned, "indel")
                log.info("kalign: %d orphan microInDels removed", n)
            stats = kalign.write_sam(
                args.outfile, idx, aligned, cmdline=" ".join(sys.argv),
                emit_unmapped=(args.format == 1), snp_caller=caller,
                stats_path=args.statsfile)
        log.info("kalign: %d reads, %s; tier 1 by read length %s on %s",
                 sum(stats.values()), dict(stats),
                 dict.fromkeys(al._schedules, "v3"), device)
    if caller is not None:
        with t.phase("snp call"):
            calls = caller.call()
        if args.snpfile.endswith(".vcf"):
            snp.write_snps_vcf(args.snpfile, calls)
        else:
            snp.write_snps_csv(args.snpfile, calls)
        log.info("snps: %d accepted -> %s", len(calls), args.snpfile)
    log.info("phases: %s", json.dumps(t.phases))
    return 0


def cmd_hammings(args) -> int:
    """ngskit4b hammings equivalent (hammings.cpp; mode enum :99-106)."""
    from .kmer import hammings
    infiles = args.infile if isinstance(args.infile, list) else [args.infile]
    if args.mode == 3:          # ePMmerge: elementwise min over node files
        loaded = [hammings.load_dists(p) for p in infiles]
        names, dists = hammings.merge_dists(loaded)
        hammings.save_dists(args.outfile, names, dists)
        print(f"hammings merge: {len(infiles)} node files -> "
              f"{args.outfile}")
        return 0
    if args.mode in (4, 5):     # ePMtrans / ePMtransCSV conversions
        names, dists = hammings.load_dists(infiles[0])
        hammings.save_dists(args.outfile, names, dists)
        print(f"hammings trans: {infiles[0]} -> {args.outfile}")
        return 0
    if (args.ring or args.mesh) and not args.restricted:
        raise NotImplementedError("hammings -M/-R (multi-device) is not "
                                  "ported yet: ROADMAP.md queue A item 10")
    device = resolve(args.device)
    t = PhaseTimer()
    with t.phase("load genome"):
        g = Genome.load(infiles[0])
    with t.phase("sweep"):
        if args.restricted:
            # the lexicographic (SA-IS) index: restricted mode cuts
            # buckets, so its answer depends on their order
            idx = SfxIndex.build(g)
            hd = hammings.hammings_restricted(
                idx, args.kmerlen, max_hamming=args.restricted,
                antisense=not args.watsononly, device=device)
        else:
            hd = hammings.hammings_exhaustive(
                g.seq, args.kmerlen, antisense=not args.watsononly,
                node=args.node - 1, numnodes=args.numnodes, device=device)
    with t.phase("write"):
        if args.outfile.endswith(".csv"):
            hammings.write_csv(args.outfile, g, hd, args.kmerlen)
        elif args.outfile.endswith(".npy"):
            np.save(args.outfile, hd)
        else:   # reference quick-load .hmg binary (tsHHamHdr)
            names, dists = hammings.split_by_chrom(g, hd, args.kmerlen)
            hammings.write_hmg(args.outfile, names, dists)
    log.info("hammings: K=%d node %d/%d on %s -> %s (phases %s)",
             args.kmerlen, args.node, args.numnodes, device, args.outfile,
             json.dumps(t.phases))
    return 0


def _cultivars(specs) -> dict[str, list[str]]:
    """`NAME=fa1,fa2` specs -> {name: [paths]}."""
    cults = {}
    for spec in specs:
        name, paths = spec.split("=", 1)
        cults[name] = paths.split(",")
    return cults


def cmd_pseudogenome(args) -> int:
    """ngskit4b pseudogenome equivalent (genpseudogenome.cpp)."""
    from .io.fasta import SeqRecord, write_fasta
    from .kmer import kmarkers
    g, cc, names = kmarkers.build_pseudogenome(_cultivars(args.cultivar))
    write_fasta(args.outfile, [SeqRecord(g.names[i], "", g.chrom_codes(i))
                               for i in range(g.nchroms())])
    if args.bedfile:
        kmarkers.write_pseudogenome_bed(args.bedfile, g, cc, names)
    log.info("pseudogenome: %d cultivars, %d chroms, %d bp -> %s",
             len(names), g.nchroms(), g.total_len, args.outfile)
    return 0


def cmd_kmarkers(args) -> int:
    """ngskit4b kmarkers equivalent (CLocKMers)."""
    from .kmer import kmarkers
    device = resolve(args.device)
    t = PhaseTimer()
    with t.phase("pseudogenome+index"):
        g, cc, names = kmarkers.build_pseudogenome(_cultivars(args.cultivar))
        idx = SfxIndex.build(g)
    if args.target not in names:
        raise ValueError(f"target cultivar {args.target!r} not in {names}")
    stats = {}
    with t.phase("markers"):
        markers = kmarkers.find_cultivar_markers(
            idx, cc, names.index(args.target),
            kmer_len=args.kmerlen, min_hamming=args.minhamming,
            extend=(args.mode == 1) and not args.noextend, device=device,
            stats=stats)
    kmarkers.write_markers_fasta(args.outfile, markers)
    log.info("kmarkers: %d markers (%d bp) for %s -> %s",
             len(markers), sum(m.length for m in markers), args.target,
             args.outfile)
    log.info("kmarkers: positions by tier %s on %s", stats, device)
    log.info("phases: %s", json.dumps(t.phases))
    return 0


def cmd_prekmarkers(args) -> int:
    """ngskit4b prekmarkers equivalent (CMarkerKMers): host numpy only."""
    from . import dna
    from .kmer import kmarkers
    t = PhaseTimer()
    with t.phase("pseudogenome+index"):
        g, cc, names = kmarkers.build_pseudogenome(_cultivars(args.cultivar))
        idx = SfxIndex.build(g)
    with t.phase("walk"):
        if args.suffixlen:
            # homozygotic-constraint mode (-s/-S): suffix region must
            # discriminate the cultivars (GenKMerCultsCnts,
            # SfxArray.cpp:2902)
            out = kmarkers.shared_prefix_suffix_markers(
                idx, cc, len(names), prefix_len=args.kmerlen,
                suffix_len=args.suffixlen,
                min_cultivars=args.mincultivars,
                max_homozygotic=args.maxhomozygotic)
        else:
            out = kmarkers.shared_prefix_markers(
                idx, cc, len(names), kmer_len=args.kmerlen,
                min_cultivars=args.mincultivars,
                max_per_cultivar=args.maxpercultivar)
    with open(args.outfile, "w") as f:
        f.write("\"KMer\"," + ",".join(f'"{n}"' for n in names) + "\n")
        for codes, counts in out:
            f.write(dna.decode(codes) + ","
                    + ",".join(str(int(c)) for c in counts) + "\n")
    log.info("prekmarkers: %d shared K-mers -> %s", len(out), args.outfile)
    return 0


def _kalign_args(p: argparse.ArgumentParser) -> None:
    """kit4b_tpu's kalign flags, copied; those in _KALIGN_UNPORTED raise."""
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-I", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--csindex", action="store_true",
                   help="write CSI index beside BAM output (not ported yet)")
    p.add_argument("--baindex", action="store_true",
                   help="write coordinate-sorted BAM + .bai (not ported yet)")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 std, 1 more sensitive, 2 ultra, 3 less")
    p.add_argument("-M", "--format", type=int, default=0,
                   help="0 SAM accepted only, 1 SAM all reads")
    p.add_argument("-s", "--substitutions", type=int, default=5)
    p.add_argument("-r", "--editdelta", type=int, default=1)
    p.add_argument("-R", "--maxmulti", type=int, default=5)
    p.add_argument("-n", "--maxns", type=int, default=1)
    p.add_argument("-S", "--snp", dest="snpfile", default=None,
                   help="SNP output (.csv or .vcf)")
    p.add_argument("-g", "--wig", dest="wigfile", default=None,
                   help="coverage WIG output (not ported yet)")
    p.add_argument("-O", "--stats", dest="statsfile", default=None,
                   help="aligner stats CSV (substitution distribution)")
    p.add_argument("--nonealign", default=None,
                   help="write unalignable reads fasta (not ported yet)")
    p.add_argument("--multialign", default=None,
                   help="write multialigned reads fasta (not ported yet)")
    p.add_argument("--markerfile", default=None,
                   help="write SNP marker sequences fasta (not ported yet)")
    p.add_argument("--markerlen", type=int, default=25,
                   help="marker 5'/3' flank length (cMinMarkerLen)")
    p.add_argument("--markerpolythres", type=float, default=0.333,
                   help="max marker base polymorphism proportion")
    p.add_argument("--snpcentroidfile", default=None,
                   help="write SNP centroid context CSV (not ported yet)")
    p.add_argument("-Z", "--include", nargs="+", default=None,
                   help="only accept hits on chroms matching these regexes "
                        "(not ported yet)")
    p.add_argument("-z", "--exclude", nargs="+", default=None,
                   help="reject hits on chroms matching these regexes "
                        "(not ported yet)")
    p.add_argument("-B", "--priorityregions", dest="priobed", default=None,
                   help="BED: accepted hits must overlap these regions "
                        "(not ported yet)")
    p.add_argument("-5", "--pcrdups", type=int, default=0,
                   help="cap accepted reads per (loci,strand); 0 disables "
                        "(not ported yet)")
    p.add_argument("-y", "--microindellen", type=int, default=0,
                   help="microInDel rescue up to this length (not ported "
                        "yet)")
    p.add_argument("-l", "--splicemax", type=int, default=0,
                   help="splice junction rescue up to this gap (not ported "
                        "yet)")
    p.add_argument("-C", "--chimeric", type=int, default=0,
                   help="chimeric trim: min retained %% of read (not ported "
                        "yet)")
    p.add_argument("-3", "--pba", dest="pbafile", default=None,
                   help="Packed Base Allele output (not ported yet)")
    p.add_argument("-X", "--disnp", dest="disnpfile", default=None,
                   help="DiSNP/TriSNP output prefix (not ported yet)")
    p.add_argument("-p", "--minsnpreads", type=int, default=5)
    p.add_argument("-P", "--qvalue", type=float, default=0.05)
    p.add_argument("-x", "--minflankexacts", type=int, default=0,
                   help="autotrim flanks (not ported yet)")
    p.add_argument("-6", "--pcrprimersubs", dest="pcrprimersubs", type=int,
                   default=0, help="PCR 5' primer correction (not ported "
                                   "yet)")
    p.add_argument("--lociconstraints", default=None,
                   help="loci base constraints CSV (not ported yet)")
    p.add_argument("--mlmode", type=int, default=0,
                   help="multiloci reads: 0 slough; 2-5 not ported yet")
    p.add_argument("--bisulfite", action="store_true",
                   help="bisulfite alignment (not ported yet)")
    p.add_argument("-b", "--batchsize", type=int, default=16384)
    p.add_argument("-T", "--threads", type=int, default=0)
    p.add_argument("-u", "--pair", dest="pairfile", nargs="+", default=None,
                   help="PE mate-2 input files")
    p.add_argument("-U", "--pemode", type=int, default=0,
                   help="0 none, 1 PE w/ orphan recovery, 2 PE no recovery, "
                        "3/4 as 1/2 but orphans processed as SE")
    p.add_argument("-d", "--pairminlen", type=int, default=100)
    p.add_argument("-D", "--pairmaxlen", type=int, default=1000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the passes on the card; cpu runs the "
                        "same PyTorch code on the CPU")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kit4b_tpu_torch", fromfile_prefix_chars="@",
        description="PyTorch/CUDA port of the kit4b_tpu toolkit")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("index", help="generate suffix index over genome")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 standard, 1 bisulfite (not ported yet)")
    p.add_argument("-r", "--ref", dest="refname", default="ref")
    p.add_argument("-T", "--threads", type=int, default=0)
    _common(p)
    p.set_defaults(fn=cmd_index)

    p = sub.add_parser("simreads", help="generate simulated readsets")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-O", "--outpe", dest="outpe", default=None)
    p.add_argument("-n", "--nreads", type=int, default=10000)
    p.add_argument("-l", "--length", type=int, default=100)
    p.add_argument("-p", "--pe", dest="pe", action="store_const", const=True,
                   default=None, help="generate paired ends")
    p.add_argument("-j", "--insertmin", type=int, default=200)
    p.add_argument("-J", "--insertmax", type=int, default=500)
    p.add_argument("-e", "--errmode", default="none",
                   choices=["none", "uniform", "illumina", "static",
                            "fixed"],
                   help="sequencer error mode (-g generrmode: illumina = "
                        "dynamic composite, static = Poisson(1) profile)")
    p.add_argument("-z", "--subsrate", type=float, default=0.01)
    p.add_argument("-Z", "--seqerrprofile", action="store_true",
                   help="uniform error positions (default Illumina "
                        "3'-skewed)")
    p.add_argument("-x", "--indelsize", type=int, default=3,
                   help="micro-InDel max size 1..9 (SimReads.cpp:137)")
    p.add_argument("-X", "--indelrate", type=float, default=0.0,
                   help="fraction of reads with a micro-InDel")
    p.add_argument("-a", "--artif5rate", type=float, default=0.0,
                   help="5' adapter artefact rate (SimReads.cpp:174)")
    p.add_argument("-A", "--artif5str", nargs="+", default=None,
                   help="5' artefact sequence(s)")
    p.add_argument("-b", "--artif3rate", type=float, default=0.0,
                   help="3' adapter artefact rate")
    p.add_argument("--artif3str", nargs="+", default=None,
                   help="3' artefact sequence(s)")
    p.add_argument("-R", "--randreads", type=float, default=0.0,
                   help="proportion of random unalignable (lcr) reads")
    p.add_argument("-N", "--snprate", type=int, default=0,
                   help="plant SNPs at this rate per Mbp")
    p.add_argument("-u", "--outsnp", default=None,
                   help="write truth SNP loci BED")
    p.add_argument("-t", "--featfile", default=None,
                   help="restrict fragments to features in this BED")
    p.add_argument("-d", "--dedupe", action="store_true",
                   help="generate unique read sequences only")
    p.add_argument("-s", "--strand", default="both", choices=["both", "+"])
    p.add_argument("-Q", "--fastq", action="store_true")
    p.add_argument("-S", "--seed", type=int, default=1)
    _common(p)
    p.set_defaults(fn=cmd_simreads)

    p = sub.add_parser("kalign", help="align reads to indexed genome")
    _kalign_args(p)
    _common(p)
    p.set_defaults(fn=cmd_kalign)

    p = sub.add_parser("hammings", help="genome-wide K-mer Hamming distances")
    p.add_argument("-i", "--in", dest="infile", required=True, nargs="+",
                   help="genome fasta (modes 0-2) or node result files "
                        "(.hmg/.csv/.npy) for merge/trans modes")
    p.add_argument("-o", "--out", dest="outfile", required=True,
                   help="output (.csv, .npy, or reference .hmg binary)")
    p.add_argument("-m", "--mode", type=int, default=1,
                   help="0/1/2 compute (restricted/exhaustive/dist), "
                        "3 merge node files (ePMmerge), 4 trans to .hmg, "
                        "5 trans to CSV (hammings.cpp:99-106)")
    p.add_argument("-K", "--kmerlen", type=int, default=25)
    p.add_argument("-N", "--node", type=int, default=1)
    p.add_argument("-n", "--numnodes", type=int, default=1)
    p.add_argument("-y", "--watsononly", action="store_true")
    p.add_argument("-M", "--mesh", action="store_true",
                   help="shard over all local devices (not ported yet)")
    p.add_argument("-R", "--ring", action="store_true",
                   help="ring over all local devices (not ported yet)")
    p.add_argument("-r", "--restricted", type=int, default=0,
                   help="pigeonhole mode bound; 0 = exhaustive")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the hand kernels and passes on the card; "
                        "cpu runs their plain PyTorch versions")
    _common(p)
    p.set_defaults(fn=cmd_hammings)

    p = sub.add_parser("pseudogenome",
                       help="concatenate cultivar fastas into pseudo-genome")
    p.add_argument("-c", "--cultivar", nargs="+", required=True,
                   metavar="NAME=fa1,fa2", help="cultivar fasta spec")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-B", "--bed", dest="bedfile", default=None)
    _common(p)
    p.set_defaults(fn=cmd_pseudogenome)

    p = sub.add_parser("kmarkers",
                       help="K-mer markers unique to a target cultivar")
    p.add_argument("-c", "--cultivar", nargs="+", required=True,
                   metavar="NAME=fa1,fa2")
    p.add_argument("-t", "--target", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-K", "--kmerlen", type=int, default=50)
    p.add_argument("-e", "--minhamming", type=int, default=2)
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 report each accepted K-mer (matches the "
                        "reference's -m0 behaviour — its extension branch "
                        "only runs under -m1, LocKMers.cpp:1209), "
                        "1 merge runs into maximal extended markers")
    p.add_argument("-x", "--noextend", action="store_true",
                   help="alias for -m0")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the pass on the card; cpu runs the same "
                        "PyTorch code on the CPU")
    _common(p)
    p.set_defaults(fn=cmd_kmarkers)

    p = sub.add_parser("prekmarkers",
                       help="prefix K-mers shared across cultivars")
    p.add_argument("-c", "--cultivar", nargs="+", required=True,
                   metavar="NAME=fa1,fa2")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-K", "--kmerlen", type=int, default=25,
                   help="prefix K-mer length")
    p.add_argument("-m", "--mincultivars", type=int, default=2)
    p.add_argument("-M", "--maxpercultivar", type=int, default=0)
    p.add_argument("-s", "--suffixlen", type=int, default=0,
                   help="suffix region length: enables the homozygotic "
                        "constraint (MarkerKMers.h:91)")
    p.add_argument("-S", "--maxhomozygotic", type=int, default=1,
                   help="report prefix only if every full-length variant "
                        "is shared by at most this many cultivars")
    _common(p)
    p.set_defaults(fn=cmd_prekmarkers)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(args.loglevel, args.logfile)
    t0 = time.time()
    summ = None
    if args.sumrslts:
        from . import __version__
        from .utils.summaries import Summaries
        summ = Summaries(args.sumrslts, args.experimentname,
                         args.experimentdescr, process=args.cmd,
                         version=__version__)
        summ.params(**{k: v for k, v in vars(args).items()
                       if k not in ("fn",) and v is not None})
    try:
        rc = args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError,
            DeviceUnavailable, NativeUnavailable) as e:
        print(f"kit4b_tpu_torch {args.cmd}: error: {e}", file=sys.stderr)
        if summ:
            summ.log(f"error: {e}")
            summ.finish(1)
        return 1
    if summ:
        summ.results(wall_seconds=round(time.time() - t0, 2))
        summ.finish(rc)
    print(f"kit4b_tpu_torch {args.cmd}: done in {time.time() - t0:.1f}s",
          file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
