"""Command-line entry of the PyTorch/CUDA port: `python -m kit4b_tpu_torch`.

Port of kit4b_tpu/cli.py with the `index` (-m 1 bisulfite too),
`simreads`, `kalign` (single and paired ends, every flag, --bisulfite),
`genpba`, `hammings`, `pseudogenome`, `kmarkers`, `prekmarkers`, `filter`,
`assemb`, `scaffold`, `pescaffold`, `mergeoverlaps`, `rnaexpr`, `genmlds`,
`sarscov2ml`, `ecreads`, `pbfilter`, `pbassemb`, `eccontigs`, `kmerdist`,
`blitz`, `hrdx`, `benchmark`, `alignsbs`, `ngsqc`, `maploci`, `rnade`,
`callhaplotypes`, `snpmarkers`, `pbautils`, `snps2pgsnps`, `lochap2bed`,
`markerseqs`, `repassemb`, `pangenome`, `seghaplotypes`, `gbsmapsnps`,
`dgts` and `locmarkers` (which refuses where the JAX package fails)
subcommands, taking the same flags and writing the same files, plus
`--device {cuda,cpu}` on the commands that use a device (`kalign`,
`genpba`, `hammings`, `kmarkers`, `filter` for -D, `scaffold`, `rnaexpr`,
`sarscov2ml`, the four PacBio commands, `blitz` and `alignsbs`). The
parsers are copies, as is all the port needs
of the JAX package: it imports none of it. Flags of paths not ported yet
parse as in kit4b_tpu and raise NotImplementedError naming their ROADMAP
item.
"""
from __future__ import annotations

import argparse
import json
import os
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
    """ngskit4b index equivalent (kit4bax.cpp:73 kingsax): SA-IS + bucket
    LUT on the port's host library, written as a .kix that either package
    loads; -m 1 builds the bisulfite index (two collapsed-genome indexes,
    a .kbx)."""
    t = PhaseTimer()
    with t.phase("load genome"):
        g = Genome.load(*args.infile)
    if args.mode == 1:   # bisulfite index (kit4bax -m1)
        from .align.bisulfite import BsIndex
        with t.phase("build bisulfite index"):
            bidx = BsIndex.build(g)
        with t.phase("write index"):
            bidx.save(args.outfile)
        log.info("index: bisulfite, %d seqs, %d bp, lut_k=%d -> %s",
                 g.nchroms(), g.total_len, bidx.lut_k, args.outfile)
        return 0
    with t.phase("build suffix index"):
        idx = SfxIndex.build(g)
    with t.phase("write index"):
        idx.save(args.outfile)
    log.info("index: %d seqs, %d bp, lut_k=%d, %d clean suffixes -> %s",
             g.nchroms(), g.total_len, idx.lut_k, len(idx.sa_clean),
             args.outfile)
    return 0


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


# kalign flags that change the records or need them listed, so the run
# leaves the native formatter for the per-record route (dest -> flag)
_KALIGN_RECORD_FLAGS = {
    "minflankexacts": "-x", "pcrprimersubs": "-6",
    "lociconstraints": "--lociconstraints", "mlmode": "--mlmode",
    "nonealign": "--nonealign", "multialign": "--multialign",
    "include": "-Z", "exclude": "-z", "priobed": "-B", "pcrdups": "-5",
}


def _kalign_bisulfite(args) -> int:
    """kalign --bisulfite SE flow (reference -b, KAlignerCL.cpp:220): the
    JAX package's, reads grouped by length, a short batch padded with its
    first read, accepted records MAPQ 254 with the XB:A:B tag."""
    from .align.bisulfite import BsAligner, BsIndex
    from .io.sam import (FLAG_REVERSE, FLAG_UNMAPPED, SamAlignment,
                         SamWriter, seq_qual_for_strand)
    device = resolve(args.device)
    idx = BsIndex.load(args.sfxfile)
    al = BsAligner(idx, max_subs=args.substitutions,
                   mm_delta=args.editdelta, max_ns=args.maxns,
                   batch_size=args.batchsize, device=device)
    g = idx.genome
    recs = []
    for path in args.infile:
        recs.extend(read_seqs(path))
    n_acc = 0
    with SamWriter(args.outfile, g.names, g.lengths,
                   pg_cl=" ".join(sys.argv)) as w:
        by_len: dict = {}
        for r in recs:
            by_len.setdefault(len(r.codes), []).append(r)
        for group in by_len.values():
            B = al.batch_size
            for s in range(0, len(group), B):
                chunk = group[s:s + B]
                arr = np.stack([r.codes for r in chunk])
                if len(chunk) < B:
                    arr = np.concatenate(
                        [arr, np.repeat(arr[:1], B - len(chunk), axis=0)])
                raw = al.align_batch_raw(arr)
                for i, rec in enumerate(chunk):
                    if raw["nar"][i] == 0:
                        n_acc += 1
                        rev = int(raw["strand"][i]) == 1
                        ci, off = g.locate(
                            np.array([int(raw["pos"][i])]))
                        seq, qual = seq_qual_for_strand(
                            rec.codes, rec.qual, rev)
                        w.write(SamAlignment(
                            qname=rec.name,
                            flag=FLAG_REVERSE if rev else 0,
                            rname=g.names[int(ci[0])],
                            pos=int(off[0]) + 1, mapq=254,
                            cigar=f"{len(rec.codes)}M", seq=seq, qual=qual,
                            tags=(f"NM:i:{int(raw['mm'][i])}",
                                  "XB:A:B")))
                    elif args.format == 1:
                        seq, qual = seq_qual_for_strand(
                            rec.codes, rec.qual, False)
                        w.write(SamAlignment(
                            qname=rec.name, flag=FLAG_UNMAPPED, rname="*",
                            pos=0, mapq=0, cigar="*", seq=seq, qual=qual))
    log.info("kalign bisulfite: %d/%d accepted on %s", n_acc, len(recs),
             device)
    return 0


def _se_phases(args, idx, aligned: list) -> list:
    """The single-end post-alignment phases in the reference's order
    (KAligner.cpp Align :617-:656, then the orphan removal :668/:680 and
    the side files :712/:725), as the JAX package runs them."""
    from .align import phases
    if args.mlmode in (3, 4):
        n = phases.assign_multi_matches(aligned)
        log.info("kalign mlmode%d: assigned %d multiloci reads",
                 args.mlmode, n)
    elif args.mlmode == 2:
        n = phases.assign_multi_random(aligned)
        log.info("kalign mlmode2: randomly assigned %d", n)
    elif args.mlmode == 5:
        aligned = phases.expand_multi_all(aligned)
    if args.lociconstraints:
        cons = phases.load_loci_constraints(args.lociconstraints,
                                            idx.genome)
        n = phases.identify_constraint_violations(aligned, cons)
        log.info("kalign: %d loci constraint violations", n)
    if args.pcrprimersubs:
        st = phases.pcr5_primer_correct(
            aligned, idx.genome.seq, args.substitutions, 12)
        log.info("kalign pcr5: %s", st)
    if args.minflankexacts:
        st = phases.auto_trim_flanks(aligned, idx.genome.seq,
                                     args.minflankexacts)
        log.info("kalign autotrim: %s", st)
    if args.splicemax:
        n = phases.remove_orphan_junctions(aligned, "splice")
        log.info("kalign: %d orphan splice junctions removed", n)
    if args.microindellen:
        n = phases.remove_orphan_junctions(aligned, "indel")
        log.info("kalign: %d orphan microInDels removed", n)
    if args.nonealign:
        n = phases.report_none_aligned(args.nonealign, aligned)
        log.info("kalign: %d unalignable reads -> %s", n, args.nonealign)
    if args.multialign:
        n = phases.report_multi_align(args.multialign, aligned)
        log.info("kalign: %d multialigned reads -> %s", n, args.multialign)
    return aligned


def cmd_kalign(args) -> int:
    """ngskit4b kalign equivalent (KAlignerCL.cpp / KAligner.cpp), in the
    JAX package's order. Single ends: a run that asks for nothing that
    changes records writes SAM through the native formatter
    (`write_sam_fast`); the rescues (-y -l -C), the phases (-x -6
    --lociconstraints --mlmode, the side files), the filters (-Z -z -B -5)
    and BAM output take the per-record route: align_records, the phases,
    the filters, then `write_sam` (a BAI with --baindex, a CSI with
    --csindex). Paired ends (-u) run align.pe and, as in the JAX package,
    none of the single-end phases and filters. Then, for -S, -g or -3, the
    SNP call and its side files (markers, centroids, SNP CSV/VCF, WIG,
    PBA, DiSNP/TriSNP). --bisulfite aligns against an `index -m 1`
    index."""
    from .align import kalign
    if args.bisulfite:
        return _kalign_bisulfite(args)
    device = resolve(args.device)
    per_record = {flag for dest, flag in _KALIGN_RECORD_FLAGS.items()
                  if getattr(args, dest)}
    if args.pairfile and args.outfile.endswith(".bam"):
        raise ValueError(
            "kalign -u writes no BAM: the JAX package writes SAM text into "
            "a file named *.bam here (ROADMAP.md queue C, 'Paired ends and "
            "the single-end options'); give the output a .sam name")
    t = PhaseTimer()
    with t.phase("load index"):
        idx = SfxIndex.load(args.sfxfile)
    sens = {0: "default", 1: "more", 2: "ultra", 3: "less"}[args.mode]
    # PCR 5' primer correction aligns with extra allowed subs
    # (KAlignerCL.cpp:268), corrected back to -s afterwards
    al = kalign.KAligner(idx,
                         max_subs=args.substitutions + args.pcrprimersubs,
                         mm_delta=args.editdelta, max_ml=args.maxmulti,
                         max_ns=args.maxns, batch_size=args.batchsize,
                         sens=sens, micro_indel=args.microindellen,
                         splice_max=args.splicemax,
                         chimeric_pct=args.chimeric, device=device)
    if args.mlmode in (2, 3, 4, 5):
        al._force_full = True   # multiloci assignment needs the hit lists
    caller = None
    if args.snpfile or args.wigfile or args.pbafile:
        from .align import snp     # imports scipy: only when it is asked for
        caller = snp.SnpCaller(idx.genome, snp.SnpOptions(
            min_snp_reads=args.minsnpreads, qvalue=args.qvalue))

    def stream(paths):
        for path in paths:
            yield from read_seqs(path)

    if args.pairfile:  # paired-end mode (-U/-u/-d/-D)
        from .align import pe
        if per_record:
            log.info("kalign PE: the single-end phases and filters %s do "
                     "not apply to paired ends and are ignored, as in the "
                     "JAX package", sorted(per_record))
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
    elif al._use_compact() and not per_record \
            and not args.outfile.endswith(".bam"):
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
        with t.phase("align"):
            aligned = list(al.align_records(stream(args.infile)))
        with t.phase("phases"):
            aligned = _se_phases(args, idx, aligned)
        if args.include or args.exclude or args.priobed or args.pcrdups:
            pbed = None
            if args.priobed:
                from .io.bed import BedFile
                pbed = BedFile.load(args.priobed)
            with t.phase("filters"):
                aligned = list(kalign.filter_alignments(
                    aligned, idx.genome, chrom_include=args.include,
                    chrom_exclude=args.exclude, priority_bed=pbed,
                    max_pcr_dups=args.pcrdups))
        with t.phase("write"):
            stats = kalign.write_sam(
                args.outfile, idx, aligned, cmdline=" ".join(sys.argv),
                emit_unmapped=(args.format == 1), snp_caller=caller,
                stats_path=args.statsfile,
                bam_index=("csi" if args.csindex else args.baindex))
        log.info("kalign: %d reads, %s; tier 1 by read length %s on %s",
                 sum(stats.values()), dict(stats),
                 dict.fromkeys(al._schedules, "v3"), device)
    if caller is not None:
        _snp_outputs(args, idx, caller, t)
    log.info("phases: %s", json.dumps(t.phases))
    return 0


def _snp_outputs(args, idx, caller, t: PhaseTimer) -> None:
    """The SNP call and its side files, in the JAX package's order."""
    from .align import snp
    with t.phase("snp call"):
        calls = caller.call()
    if args.markerfile:
        n = snp.report_markers(args.markerfile, caller, calls,
                               marker5_len=args.markerlen,
                               marker3_len=args.markerlen,
                               poly_thres=args.markerpolythres)
        log.info("snps: %d marker sequences -> %s", n, args.markerfile)
    if args.snpcentroidfile:
        cent = snp.snp_centroids(caller, calls)
        snp.write_snp_centroids_csv(args.snpcentroidfile, cent)
        log.info("snps: centroid distributions -> %s",
                 args.snpcentroidfile)
    if args.snpfile:
        if args.snpfile.endswith(".vcf"):
            snp.write_snps_vcf(args.snpfile, calls)
        else:
            snp.write_snps_csv(args.snpfile, calls)
        log.info("snps: %d accepted -> %s", len(calls), args.snpfile)
    if args.wigfile:
        from .io.wig import write_wig
        write_wig(args.wigfile, idx.genome, caller.coverage())
    if args.pbafile:
        from .kmer.pba import pba_from_counts, save_pba
        counts = caller._counts.reshape(-1, 5)
        save_pba(args.pbafile, idx.genome, pba_from_counts(counts))
        log.info("pba: -> %s", args.pbafile)
    if args.disnpfile and calls:
        with t.phase("disnp"):
            di = snp.call_multisnps(args.outfile, calls, order=2)
            snp.write_multisnps_csv(args.disnpfile + ".disnp.csv", di, 2)
            tri = snp.call_multisnps(args.outfile, calls, order=3)
            snp.write_multisnps_csv(args.disnpfile + ".trisnp.csv", tri, 3)
        log.info("disnp: %d pairs, %d triples", len(di), len(tri))


def cmd_genpba(args) -> int:
    """ngskit4b genpba equivalent (KAlignerCL.cpp:1491 kalignerPBA):
    kalign in PBA output mode, aligning readsets and writing only the
    Packed Base Allele file (plus the SAM with --sam). The flags genpba
    does not take are kalign's defaults."""
    if args.microindellen or args.splicemax:
        raise ValueError(
            "genpba -y/-l: the JAX package's genpba fails with these "
            "(AttributeError: its namespace has no mlmode; ROADMAP.md queue "
            "C, '`genpba -y` or `-l` fails'); run kalign -3 instead")
    defaults = vars(build_parser().parse_args(
        ["kalign", "-i", "-", "-I", "-", "-o", "-"]))
    for k, v in defaults.items():
        if not hasattr(args, k):
            setattr(args, k, v)
    args.pbafile = args.outfile
    args.outfile = args.samfile or os.devnull
    return cmd_kalign(args)


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


def cmd_filter(args) -> int:
    """ngskit4b filter equivalent (CArtefactReduce). Only -D (the
    near-duplicate pass) touches the device."""
    from .assembly import filter as filt
    from .assembly.store import SeqStore
    from .io.fasta import write_fasta
    t = PhaseTimer()
    if args.checkpoint and os.path.exists(str(args.checkpoint) + ".npz"):
        with t.phase("load checkpoint"):
            store = SeqStore.load(args.checkpoint)
        log.info("filter: resumed %d seqs from checkpoint", len(store))
    else:
        with t.phase("load reads"):
            r1 = []
            for p_ in args.infile:
                r1.extend(read_seqs(p_))
            r2 = None
            if args.pairfile:
                r2 = []
                for p_ in args.pairfile:
                    r2.extend(read_seqs(p_))
            if args.adapters:
                from .assembly.contaminants import trim_adapters
                # min_len=0: keep PE lists aligned; SeqStore.from_records
                # drops under-length reads pair-wise afterwards
                r1, st1 = trim_adapters(r1, min_len=0)
                log.info("filter adapters r1: %s", st1)
                if r2 is not None:
                    r2, st2 = trim_adapters(r2, min_len=0)
                    log.info("filter adapters r2: %s", st2)
            store = SeqStore.from_records(
                r1, r2, min_phred=args.minphred, trim5=args.trim5,
                trim3=args.trim3, min_len=args.minlen)
        if args.checkpoint:
            store.save(args.checkpoint)
    params = filt.FilterParams(
        dedup=not args.nodedup, near_dup_subs=args.neardup,
        min_overlap_pct=args.minoverlap, overlap_passes=args.passes)
    with t.phase("filter"):
        out = filt.artefact_reduce(
            store, params,
            progress=lambda what, n: log.info("filter %s: removed %d",
                                              what, n),
            device=args.device)
    with t.phase("write"):
        write_fasta(args.outfile, out.to_fasta_records("read"))
    log.info("filter: %d -> %d seqs -> %s", len(store), out.n_live(),
             args.outfile)
    return 0


def cmd_assemb(args) -> int:
    """ngskit4b assemb equivalent (CdeNovoAssemb): host numpy only."""
    from .assembly import assemble as asmb
    from .assembly.store import SeqStore
    from .io.fasta import write_fasta
    t = PhaseTimer()
    with t.phase("load"):
        if args.pairfile:
            r1 = [r for p_ in args.infile for r in read_seqs(p_)]
            r2 = [r for p_ in args.pairfile for r in read_seqs(p_)]
            store = SeqStore.from_records(r1, r2)
        else:
            store = SeqStore.from_arrays(
                [r.codes for p_ in args.infile for r in read_seqs(p_)])
    params = asmb.AssembleParams(
        min_overlap=args.minoverlap, min_overlap_final=args.minoverlapfinal,
        max_subs_per_100=args.subs, max_passes=args.maxpasses,
        checkpoint_every=args.passthres,
        checkpoint_path=args.outfile + ".pass")
    with t.phase("assemble"):
        out = asmb.assemble(
            store, params,
            progress=lambda p, e, a, c, n: log.info(
                "pass %d: %d edges, %d merges, %d contained, %d live",
                p, e, a, c, n))
    with t.phase("write"):
        write_fasta(args.outfile, out.to_fasta_records("contig"))
    lens = sorted((int(out.lengths[i]) for i in range(len(out))),
                  reverse=True)
    half = sum(lens) / 2
    acc, n50 = 0, 0
    for ln in lens:
        acc += ln
        if acc >= half:
            n50 = ln
            break
    log.info("assemb: %d contigs, total %d bp, N50 %d -> %s",
             len(lens), sum(lens), n50, args.outfile)
    return 0


def cmd_pescaffold(args) -> int:
    """ngskit4b pescaffold equivalent (CPEScaffold): host only."""
    from .assembly.scaffold import ScaffoldParams, pescaffold
    paths, recs = pescaffold(
        args.pe1sam, args.pe2sam, args.contigs, args.outfile,
        ScaffoldParams(min_links=args.minlinks, default_gap=args.gap))
    joined = sum(1 for p_ in paths if len(p_) > 1)
    log.info("pescaffold: %d scaffolds (%d multi-contig) -> %s",
             len(paths), joined, args.outfile)
    return 0


def cmd_scaffold(args) -> int:
    """ngskit4b scaffold equivalent (CScaffolder, sequence-aware): the
    mates are aligned onto the contigs by kalign on the device."""
    from .assembly.scaffold import ScaffoldParams, scaffold_contigs
    paths, recs = scaffold_contigs(
        args.contigs, args.pe1, args.pe2, args.outfile,
        ScaffoldParams(min_links=args.minlinks, default_gap=args.gap,
                       insert_size=args.insert),
        max_subs=args.subs, min_contig=args.minctg, device=args.device)
    joined = sum(1 for p_ in paths
                 if len([e for e in p_ if e[0] != ""]) > 1)
    log.info("scaffold: %d scaffolds (%d multi-contig) -> %s",
             len(paths), joined, args.outfile)
    return 0


def cmd_mergeoverlaps(args) -> int:
    """ngskit4b mergeoverlaps equivalent (CMergeReadPairs): host only."""
    from .assembly.mergepairs import MergeParams, merge_pairs
    from .io.fasta import write_fasta, write_fastq
    r1 = [r for p_ in args.infile for r in read_seqs(p_)]
    r2 = [r for p_ in args.pairfile for r in read_seqs(p_)]
    merged, kept, stats = merge_pairs(
        r1, r2, MergeParams(min_overlap=args.minoverlap,
                            max_subs_pct=args.subs))
    writer = write_fastq if any(m.qual is not None for m in merged) \
        else write_fasta
    writer(args.outfile, merged)
    if args.unmerged1:
        writer(args.unmerged1, [a for a, _ in kept])
        writer(args.unmerged2, [b for _, b in kept])
    log.info("mergeoverlaps: %s -> %s", stats, args.outfile)
    return 0


def cmd_rnaexpr(args) -> int:
    """ngskit4b rnaexpr equivalent (CRNAExpr mode 0)."""
    import csv
    from .align import rnaexpr
    samples, features, counts = rnaexpr.load_counts_matrix(args.infile)
    partners = None
    if args.samplesfile:
        partners = {}
        with open(args.samplesfile, newline="") as f:
            for row in csv.reader(f):
                if len(row) >= 2:
                    partners[row[0].strip().strip('"')] = \
                        row[1].strip().strip('"')
    results = rnaexpr.replicate_consistency(samples, counts, partners,
                                            device=args.device)
    rnaexpr.write_consistency_csv(args.outfile, results)
    bad = [r["sample"] for r in results if not r["consistent"]]
    log.info("rnaexpr: %d samples, %d inconsistent (%s) -> %s",
             len(results), len(bad), ",".join(bad[:10]), args.outfile)
    return 0


def cmd_genmlds(args) -> int:
    """ngskit4b genmlds equivalent (CGenMLdatasets): host only."""
    from .tools import mlds
    labels = mlds.load_sample_labels(args.labels) if args.labels \
        else None
    ns, nf = mlds.transpose_dataset(args.infile, args.outfile, labels)
    log.info("genmlds: %d samples x %d features -> %s", ns, nf,
             args.outfile)
    return 0


def cmd_sarscov2ml(args) -> int:
    """ngskit4b sarscov2ml equivalent (CSarsCov2ML mode 0)."""
    import csv
    from .tools import mlds
    with open(args.infile, newline="") as f:
        rows = [r for r in csv.reader(f) if r]
    feat_names = [h.strip().strip('"') for h in rows[0][1:]]
    mat = np.array([[float(v or 0) for v in r[1:]] for r in rows[1:]])
    linkages = mlds.find_feature_linkages(
        mat, feat_names, num_linked=args.numlinkedfeatures,
        min_rows=args.minlinkedrows, min_class=args.featclassvalue,
        device=args.device)
    mlds.write_linkages_csv(args.outfile, linkages)
    log.info("sarscov2ml: %d linkages -> %s", len(linkages),
             args.outfile)
    return 0


def cmd_ecreads(args) -> int:
    """pacbiokit4b ecreads equivalent (CPBErrCorrect)."""
    from .io.fasta import write_fasta
    from .pacbio.ecreads import ECParams, correct_reads
    recs = list(read_seqs(args.infile))
    corr = correct_reads(recs, ECParams(
        min_read_len=args.minreadlen,
        min_corrected_len=args.mincorrectedlen, band=args.band),
        device=resolve(args.device))
    write_fasta(args.outfile, corr)
    log.info("ecreads: %d reads in -> %d corrected -> %s",
             len(recs), len(corr), args.outfile)
    return 0


def cmd_pbfilter(args) -> int:
    """pacbiokit4b filter equivalent (CPBFilter, SMRTbell hairpins)."""
    from .io.fasta import write_fasta
    from .pacbio.pbfilter import FilterParams, filter_reads
    out, stats = filter_reads(list(read_seqs(args.infile)),
                              FilterParams(min_len=args.minlen,
                                           trim=args.trim),
                              device=resolve(args.device))
    write_fasta(args.outfile, out)
    log.info("pbfilter: %s -> %s", json.dumps(stats), args.outfile)
    return 0


def cmd_pbassemb(args) -> int:
    """pacbiokit4b contigs equivalent (CPBAssemb)."""
    from .io.fasta import write_fasta
    from .pacbio.pbassemb import AssembParams, assemble
    contigs = assemble(list(read_seqs(args.infile)),
                       AssembParams(min_overlap=args.minoverlap,
                                    min_identity=args.minidentity),
                       device=resolve(args.device))
    write_fasta(args.outfile, contigs)
    log.info("pbassemb: %d contigs -> %s", len(contigs), args.outfile)
    return 0


def cmd_eccontigs(args) -> int:
    """pacbiokit4b eccontigs equivalent (CPBECContigs)."""
    from .io.fasta import write_fasta
    from .pacbio.ecreads import ECParams
    from .pacbio.pbassemb import polish_contigs
    polished = polish_contigs(list(read_seqs(args.infile)),
                              list(read_seqs(args.reads)),
                              ECParams(min_read_len=0, min_corrected_len=0),
                              device=resolve(args.device))
    write_fasta(args.outfile, polished)
    log.info("eccontigs: %d contigs polished -> %s",
             len(polished), args.outfile)
    return 0


def cmd_kmerdist(args) -> int:
    """pacbiokit4b kmerdist equivalent (CMAFKMerDist)."""
    from .pacbio.kmerdist import kmer_dist, write_kmer_dist
    d = kmer_dist(args.infile, max_k=args.maxk)
    write_kmer_dist(args.outfile, d)
    log.info("kmerdist: %d blocks, %d positions -> %s",
             d["blocks"], d["positions"], args.outfile)
    return 0


def cmd_blitz(args) -> int:
    """ngskit4b blitz equivalent (CBlitz local aligner); the gapped
    refinement's SW batches run on --device."""
    from .align.blitz import blitz_align, write_psl
    dev = resolve(args.device)
    idx = SfxIndex.load(args.sfxfile)
    recs = [r for p_ in args.infile for r in read_seqs(p_)]
    hits = blitz_align(idx, recs, stride=args.stride,
                       min_hits=args.minhits, band=args.band,
                       min_score=args.minscore, gapped=args.gapped,
                       device=dev)
    q_lens = {r.name: len(r.codes) for r in recs}
    t_lens = {n: int(l) for n, l in zip(idx.genome.names,
                                        idx.genome.lengths)}
    write_psl(args.outfile, hits, q_lens, t_lens)
    log.info("blitz: %d queries, %d hits -> %s", len(recs), len(hits),
             args.outfile)
    return 0


def cmd_hrdx(args) -> int:
    """kit4bhrdx equivalent (CHomozyReduce); host only."""
    from .assembly.hrdx import reduce_homozygous, write_reduced
    recs = [r for p_ in args.infile for r in read_seqs(p_)]
    kept, stats = reduce_homozygous(
        recs, max_homozy_subs=args.maxhomozysubs,
        min_homozy_len=args.minhomozylen, min_het_len=args.minhetrozylen,
        min_ctg_len=args.minctglen)
    write_reduced(args.outfile, kept)
    log.info("hrdx: %s -> %s", stats, args.outfile)
    return 0


def cmd_benchmark(args) -> int:
    """ngskit4b benchmark equivalent. Modes (Benchmarker.h:21-26):
    0 limit raw reads, 1 generate observed CIGARs from alignments,
    2 simulate reads replaying observed CIGARs, 3 score alignments
    against ground truth; mode 4 is the simreads-truth scorer
    (descriptor-based whole-read scoring). Host only."""
    from .align import magicbench as mb
    if args.mode == 0:
        n = mb.limit_reads(args.infile, args.outfile, args.maxreads)
        log.info("benchmark limitreads: %d reads -> %s", n, args.outfile)
        return 0
    if args.mode == 1:
        g = Genome.load(args.refgenome)
        profiles = mb.gen_obs_cigars(args.infile, g,
                                     max_reads=args.maxreads, pe=args.pe)
        mb.write_obs_cigars(args.cigarsfile, profiles, pe=args.pe)
        log.info("benchmark gencigars: %d observed profiles -> %s",
                 len(profiles), args.cigarsfile)
        return 0
    if args.mode == 2:
        from .io.fasta import write_fasta
        g = Genome.load(args.refgenome)
        profiles, pe = mb.read_obs_cigars(args.cigarsfile)
        pe = pe or args.pe
        se, pe2 = mb.sim_reads_from_profiles(g, profiles, args.maxreads,
                                             pe=pe, seed=args.seed)
        write_fasta(args.outfile, se)
        if pe and args.outpe2:
            write_fasta(args.outpe2, pe2)
        log.info("benchmark simreads: %d reads (%d profiles) -> %s",
                 len(se), len(profiles), args.outfile)
        return 0
    if args.mode == 3:
        truth_files = [args.groundtruth] + \
            ([args.outpe2] if args.outpe2 else [])
        gt = mb.load_ground_truth(*truth_files)
        sc = mb.score_alignments(args.infile, gt, pe=args.pe)
        res = sc.measures(args.fbetabases, args.fbetareads)
        res.update(ground_truth=sc.n_ground_truth, scored=sc.n_scored,
                   bases_correct=sc.bases_correct,
                   bases_incorrect=sc.bases_incorrect,
                   bases_unclaimed=sc.bases_unclaimed)
        out = json.dumps(res, indent=2)
        if args.outfile:
            with open(args.outfile, "w") as f:
                f.write(out + "\n")
        else:
            print(out)
        log.info("benchmark score: Fb(bases)=%.3f Fb(reads)=%.3f",
                 res["fbeta_bases"], res["fbeta_reads"])
        return 0
    from .align.benchmark import score_sam
    r = score_sam(args.infile, tolerance=args.tolerance)
    out = json.dumps(r.summary(), indent=2)
    if args.outfile:
        with open(args.outfile, "w") as f:
            f.write(out + "\n")
    else:
        print(out)
    log.info("benchmark: %d reads scored", r.n_reads)
    return 0


def cmd_alignsbs(args) -> int:
    """ngskit4b alignsbs equivalent (CAlignsBootstrap); the aligner runs
    on --device."""
    from .align import alignsbs
    dev = resolve(args.device)
    qseqs = list(read_seqs(args.queryseqsfile))
    tseqs = list(read_seqs(args.targseqsfile))
    qasm = Genome.load(args.queryassembfile)
    tasm = Genome.load(args.targassembfile)
    results = alignsbs.bootstrap_align(
        qseqs, qasm, tseqs, tasm, n_bootstraps=args.numbootstraps,
        max_subs=args.maxsubs, seed=args.randseed,
        sense_only=args.senseonly, device=dev)
    alignsbs.write_bootstrap_csv(args.qrsltsfile, args.trsltsfile,
                                 results)
    log.info("alignsbs: %d iterations -> %s / %s", len(results) - 1,
             args.qrsltsfile, args.trsltsfile)
    return 0


def cmd_ngsqc(args) -> int:
    """ngskit4b ngsqc equivalent (CReadStats); host only."""
    from .align.readstats import compute_readstats, write_readstats_csv

    def stream():
        for p_ in args.infile:
            yield from read_seqs(p_)
    st = compute_readstats(stream(), kmer_len=args.kmerlen)
    write_readstats_csv(args.outprefix, st, kmer_len=args.kmerlen)
    if args.contaminants:
        from .align.readstats import (compute_contaminant_stats,
                                      write_contaminant_csv)
        adapters = None
        if args.contaminants != "-":
            adapters = {r.name: r.codes
                        for r in read_seqs(args.contaminants)}
        cst = compute_contaminant_stats(stream(), adapters,
                                        min_overlap=args.mincontamlen,
                                        sub_rate=args.maxcontamsubrate)
        write_contaminant_csv(f"{args.outprefix}.contaminants.csv", cst)
        log.info("ngsqc: %d/%d reads with contaminant overlays",
                 cst["contaminated_reads"], cst["reads"])
    if args.plots:
        from .align.readstats import render_readstats_plots
        paths = render_readstats_plots(args.outprefix, st)
        log.info("ngsqc: rendered %d plots", len(paths))
    print(json.dumps(st.summary(), indent=2))
    log.info("ngsqc: %d reads -> %s.*", st.n_reads, args.outprefix)
    return 0


def cmd_maploci(args) -> int:
    """ngskit4b maploci equivalent (CMapLoci2Feat); host only."""
    from .io.bed import BedFile, map_loci_to_features
    from .io.sam import read_sam
    bed = BedFile.load(args.bedfile)
    counts, miss = map_loci_to_features(bed, read_sam(args.infile))
    with open(args.outfile, "w") as f:
        f.write('"Feature","Hits"\n')
        for name in sorted(counts):
            f.write(f'"{name}",{counts[name]}\n')
    log.info("maploci: %d features hit, %d loci outside features -> %s",
             len(counts), miss, args.outfile)
    return 0


def cmd_rnade(args) -> int:
    """ngskit4b rnade equivalent (CRNA_DE): per-feature binned coverage,
    Poisson-bootstrapped Pearson/fold/PValue confidence distributions,
    and the reference DE classification (rnade.cpp); host float64."""
    from .align.rnade import (load_read_loci, rnade_process,
                              write_bin_counts_csv, write_rnade_csv)
    from .io.biobed import load_gene_bed
    from .tools.convert import read_loci_csv
    zones = read_loci_csv(args.excludezones) if args.excludezones else None
    ctrl = load_read_loci(args.control, strand=args.alignstrand,
                          limit=args.limitaligned, exclude_zones=zones)
    expr = load_read_loci(args.experiment, strand=args.alignstrand,
                          limit=args.limitaligned, exclude_zones=zones)
    genes = load_gene_bed(args.bedfile)
    feats = rnade_process(
        ctrl, expr, genes, num_bins=args.numbins, region=args.region,
        min_feat_cnts=args.minfeatcnts, min_start_loci=args.minstartloci,
        coalesce_win=args.cowinlen, artifact_thres=args.artifactthres,
        norm_scale=args.normcnts, feat_strand=args.featstrand,
        filt_nonaligned=args.nonalign)
    write_rnade_csv(args.outfile, feats)
    if args.bincounts:
        write_bin_counts_csv(args.bincounts, feats)
    log.info("rnade: %d features -> %s", len(feats), args.outfile)
    return 0


def cmd_callhaplotypes(args) -> int:
    """ngskit4b callhaplotypes equivalent. Modes (CallHaplotypes.cpp -m,
    CallHaplotypes.h:98-113): 0 imputed matrix, 1 + raw matrices,
    2 + GWAS; 3 allelic haplotype grouping, 4 coverage grouping,
    5 group DGTs, 6 groupings to WIG, 7 src-vs-refs / 8 refs-vs-refs
    allelic association scores, 9 grouping by scores, 10 group
    segregating K-mers, 11 filter scores, 12 filter + transform."""
    from .utils.runtime import log
    if args.mode in (7, 8):
        from .kmer.allelescores import gen_allele_scores
        from .kmer.pba import load_pba_any
        refs = {}
        for spec in args.founder:
            name, path = spec.split("=", 1)
            refs[name] = load_pba_any(path)[1]
        srcs = {}
        for spec in (args.progeny_list or []) if args.mode == 7 else []:
            name, path = spec.split("=", 1)
            srcs[name] = load_pba_any(path)[1]
        if args.mode == 7 and not srcs:
            raise SystemExit("mode 7 needs source PBAs via -i NAME=pba")
        n = gen_allele_scores(refs, srcs, args.outfile,
                              bin_size=args.grphapbinsize or 100_000)
        log.info("callhaplotypes mode %d: %d score rows -> %s",
                 args.mode, n, args.outfile)
        return 0
    if args.mode == 9:
        from .kmer.allelescores import group_allele_scores
        res = group_allele_scores(args.allelescorefile, args.outfile,
                                  min_unpruned=args.minunprunedrefs,
                                  max_unpruned=args.maxunprunedrefs)
        log.info("callhaplotypes mode 9: %d srcs x %d refs, %d bins, "
                 "%d refs pruned -> %s{.csv,.selected.csv,.imputation*}",
                 len(res["srcs"]), len(res["refs"]), res["bins"],
                 int(res["pruned"].sum()), args.outfile)
        return 0
    if args.mode in (11, 12):
        from .kmer.allelescores import (filter_allele_scores,
                                        filter_transform_allele_scores)
        fn = (filter_allele_scores if args.mode == 11
              else filter_transform_allele_scores)
        n = fn(args.allelescorefile, args.outfile,
               src_res=args.filtsrcpbascores or None,
               ref_res=args.filtrefpbascores or None)
        log.info("callhaplotypes mode %d: %d rows -> %s", args.mode, n,
                 args.outfile)
        return 0
    if args.mode in (3, 4, 5, 6, 10):
        import numpy as np
        from .kmer import haplogroups as hgm
        from .kmer.pba import load_pba_any as load_pba
        names, mats = [], []
        chrom = None
        for spec in args.founder:
            name, path = spec.split("=", 1)
            names.append(name)
            _, chroms = load_pba(path)
            if chrom is None:
                chrom = sorted(chroms)[0] if args.chrom is None \
                    else args.chrom
            mats.append(chroms[chrom])
        pbas = np.stack(mats)
        bins = []
        bs = args.grphapbinsize or pbas.shape[1]
        for start in range(0, pbas.shape[1], bs):
            seg = pbas[:, start:start + bs]
            bins.append(hgm.gen_haplotype_groups(
                seg, chrom, start,
                coverage_mode=args.mode == 4,
                affine_gap_len=args.affinegaplen,
                min_dist=args.mincentclustdist,
                max_dist=args.maxcentclustdist,
                max_groups=args.maxclustgrps, phases=args.gpphases))
        if args.mode in (3, 4):
            hgm.report_groups_csv(args.outfile, bins, names)
        elif args.mode == 5:
            dgts = []
            for hg_bin in bins:
                seg = pbas[:, hg_bin.start:hg_bin.start + hg_bin.num_loci]
                dgts.extend(hgm.bin_dgts(
                    hg_bin, seg, min_members=args.grpdgtmbrs,
                    min_prop=args.grpdgtsamples,
                    min_fmeasure=args.grpdgtfmeasure,
                    max_report=args.maxreportgrpdgts))
            hgm.write_dgts_csv(args.outfile, dgts)
            log.info("callhaplotypes mode 5: %d DGT loci", len(dgts))
        elif args.mode == 6:
            hgm.groupings_to_wig(args.outfile, bins)
        else:
            rows = []
            for hg_bin in bins:
                seg = pbas[:, hg_bin.start:hg_bin.start + hg_bin.num_loci]
                rows.extend(hgm.group_kmers(
                    hg_bin, seg, kmer_size=args.kmersize,
                    min_hamming=args.minkmerhamming,
                    max_nocov=args.kmernonecoverage,
                    min_members=args.grpdgtmbrs))
            with open(args.outfile, "w") as f:
                f.write('"Chrom","Loci","MinHamming","MaxHamming"\n')
                for r in rows:
                    f.write(f'"{chrom}",{r["loci"]},{r["min_hamming"]},'
                            f'{r["max_hamming"]}\n')
            log.info("callhaplotypes mode 10: %d group KMers", len(rows))
        log.info("callhaplotypes mode %d: %d bins, %d samples -> %s",
                 args.mode, len(bins), len(names), args.outfile)
        return 0
    # modes 0/1/2: two-founder progeny calling; 1 adds raw matrices,
    # 2 adds GWAS files (CallHaplotypes.cpp:2218-2254)
    import os as _os
    from .kmer.callhaplotypes import (call_haplotypes, write_haplotype_calls,
                                      write_haplotype_matrix,
                                      write_haplotypes_gwas)
    founders = {}
    for spec in args.founder:
        name, path = spec.split("=", 1)
        founders[name] = path
    fnames = tuple(founders)
    progeny = args.progeny_list or []
    if not progeny:
        raise SystemExit("modes 0-2 need progeny PBA(s) via -i")
    raw_by_prog, imp_by_prog = {}, {}
    for spec in progeny:
        if "=" in spec:
            pname, ppath = spec.split("=", 1)
        else:
            pname, ppath = _os.path.basename(spec).split(".")[0], spec
        raw, calls = call_haplotypes(
            ppath, founders, bin_size=args.binsize, min_loci=args.minloci,
            ww_prox_window=args.wwrlproxwindow, return_raw=True)
        raw_by_prog[pname] = raw
        imp_by_prog[pname] = calls
        write_haplotype_calls(f"{args.outfile}.{pname}.csv"
                              if len(progeny) > 1 else args.outfile, calls)
        if args.mode >= 1:
            write_haplotype_calls(f"{args.outfile}.{pname}.raw.csv", raw)
        if args.mode >= 2:
            write_haplotypes_gwas(
                f"{args.outfile}.{pname}.raw.gwas", raw, fnames)
            write_haplotypes_gwas(
                f"{args.outfile}.{pname}.imputed.gwas", calls, fnames)
    if args.mode >= 1:
        write_haplotype_matrix(f"{args.outfile}.raw.matrix.csv",
                               raw_by_prog, fnames)
    write_haplotype_matrix(f"{args.outfile}.matrix.csv", imp_by_prog,
                           fnames)
    from collections import Counter
    log.info("callhaplotypes mode %d: %s -> %s", args.mode,
             {p: dict(Counter(c.call for c in cs))
              for p, cs in imp_by_prog.items()}, args.outfile)
    return 0

def cmd_snpmarkers(args) -> int:
    """ngskit4b snpmarkers equivalent (CMarkers)."""
    from .kmer.snpmarkers import find_snp_markers, write_snp_markers_csv
    from .utils.runtime import log
    csvs = {}
    for spec in args.cultivar:
        name, path = spec.split("=", 1)
        csvs[name] = path
    markers = find_snp_markers(csvs, min_cov=args.mincov,
                               min_purity=args.purity / 100.0)
    write_snp_markers_csv(args.outfile, markers, list(csvs))
    log.info("snpmarkers: %d markers across %d cultivars -> %s",
             len(markers), len(csvs), args.outfile)
    return 0

def cmd_pbautils(args) -> int:
    """ngskit4b pbautils equivalent (pbautils.cpp modes): 0 PBA->fasta,
    1 fasta->PBA, 2 PBA concordance, 3 WIG concordance, 4 allelic
    variant VCF, 5 genotype VCF, 6 diplotype-only VCF, 7 deletion VCF,
    8 transcribed-segment BED; plus concat/coverage extensions."""
    from .kmer import pbautils2 as pu
    from .kmer.pba import concat_pba, pba_coverage_wig
    from .kmer.pba import load_pba_any as load_pba
    from .utils.runtime import log
    mode = args.mode
    if mode == "concat":
        concat_pba(args.infile, args.outfile)
    elif mode == "coverage":
        pba_coverage_wig(args.infile[0], args.outfile)
    elif mode == "0":
        _, chroms = load_pba(args.infile[0])
        n = pu.pba_to_fasta(chroms, args.outfile)
        log.info("pbautils fasta: %d chroms", n)
    elif mode == "1":
        from .io.fasta import Genome
        from .kmer.pba import save_pba
        import numpy as np
        g = Genome.load(*args.infile)
        chroms = pu.fasta_to_pba(g)
        save_pba(args.outfile, g,
                 np.concatenate([chroms[n] for n in g.names]),
                 readset="assembly")
    elif mode in ("2", "3"):
        samples = {}
        for p_ in args.infile:
            rs, chroms = load_pba(p_)
            samples[rs] = chroms
        rows = pu.pba_concordance(samples) if mode == "2" else \
            pu.wig_concordance(samples)
        pu.write_concordance_csv(args.outfile, rows)
    elif mode == "4":
        if not args.refpba:
            raise ValueError("mode 4 requires --refpba")
        _, ref = load_pba(args.refpba)
        _, smp = load_pba(args.infile[0])
        n = pu.allelic_vcf(ref, smp, args.outfile)
        log.info("pbautils allelic VCF: %d variant loci", n)
    elif mode in ("5", "6", "7"):
        if not args.refpba:
            raise ValueError(f"mode {mode} requires --refpba")
        _, ref = load_pba(args.refpba)
        samples = {}
        for p_ in args.infile:
            rs, chroms = load_pba(p_)
            samples[rs] = chroms
        n = pu.genotype_vcf(ref, samples, args.outfile,
                            diplotype_only=mode == "6",
                            deletions=mode == "7",
                            max_na_prop=args.gtpropna,
                            min_het_prop=args.gtprophet
                            if mode == "6" else 0.0)
        log.info("pbautils genotype VCF mode %s: %d loci", mode, n)
    elif mode == "8":
        samples = {}
        for p_ in args.infile:
            rs, chroms = load_pba(p_)
            samples[rs] = chroms
        n = pu.transcribed_bed(samples, args.outfile)
        log.info("pbautils BED: %d segments", n)
    else:
        raise ValueError(f"unknown pbautils mode {args.mode}")
    log.info("pbautils %s -> %s", args.mode, args.outfile)
    return 0

def cmd_snps2pgsnps(args) -> int:
    """ngskit4b snps2pgsnps equivalent (CSNPs2pgSNPs)."""
    from .tools.snpsfmt import read_snps_csv, write_pgsnp
    from .utils.runtime import log
    snps = read_snps_csv(args.infile)
    if args.outfile.endswith(".vcf"):
        from .align.snp import SnpCall, write_snps_vcf
        calls = []
        for s in snps:
            cnts = np.array(s["counts"], np.int64)
            ref_i = "ACGTN".index(s["ref"])
            cnts[ref_i] = s["bases"] - s["mm"]
            calls.append(SnpCall(s["chrom"], s["loci"], ref_i, cnts,
                                 s["bases"], s["mm"], 0.0, s["pvalue"]))
        write_snps_vcf(args.outfile, calls)
    else:
        write_pgsnp(args.outfile, snps, track=args.track,
                    min_count=args.mincount)
    log.info("snps2pgsnps: %d SNPs -> %s", len(snps), args.outfile)
    return 0

def cmd_lochap2bed(args) -> int:
    """ngskit4b lochap2bed equivalent (Di/TriSNP haplotypes -> BED)."""
    from .tools.snpsfmt import lochap_to_bed
    from .utils.runtime import log
    n = lochap_to_bed(args.infile, args.outfile)
    log.info("lochap2bed: %d haplotypes -> %s", n, args.outfile)
    return 0

def cmd_markerseqs(args) -> int:
    """ngskit4b markerseqs equivalent (CMarkerSeq)."""
    from .io.fasta import Genome
    from .tools.snpsfmt import (marker_seqs, read_snps_csv,
                                write_marker_seqs_csv)
    from .utils.runtime import log
    g = Genome.load(args.genome)
    m = marker_seqs(g, read_snps_csv(args.infile), flank=args.flank)
    write_marker_seqs_csv(args.outfile, m)
    log.info("markerseqs: %d markers -> %s", len(m), args.outfile)
    return 0

def cmd_repassemb(args) -> int:
    """ngskit4b repassemb equivalent (replace bases w/ major alleles)."""
    from .io.fasta import Genome, SeqRecord, write_fasta
    from .tools.snpsfmt import read_snps_csv, replace_assembly_alleles
    from .utils.runtime import log
    g = Genome.load(args.genome)
    n = replace_assembly_alleles(g, read_snps_csv(args.infile),
                                 min_prop=args.minprop)
    recs = []
    for ci, name in enumerate(g.names):
        s = int(g.starts[ci])
        recs.append(SeqRecord(name, "", g.seq[s: s + int(g.lengths[ci])]))
    write_fasta(args.outfile, recs)
    log.info("repassemb: %d bases replaced -> %s", n, args.outfile)
    return 0

def cmd_pangenome(args) -> int:
    """ngskit4b pangenome equivalent (CPangenome modes 0-3)."""
    from .tools import pangenes
    from .utils.runtime import log
    if args.mode == 0:
        n = pangenes.prefix_fasta(args.infile, args.outfile, args.prefix)
        log.info("pangenome: prefixed %d descriptors -> %s", n,
                 args.outfile)
    elif args.mode == 1:
        st = pangenes.filter_sam_prefix(args.infile, args.outfile,
                                        args.prefix)
        log.info("pangenome: %s -> %s", st, args.outfile)
    else:
        n = pangenes.binned_wiggle(
            args.infile, args.outfile, bin_kbp=args.binsizekbp,
            unique_loci=(args.mode == 3),
            track_name=args.prefix or "pangenome")
        log.info("pangenome: %d wiggle bins -> %s", n, args.outfile)
    return 0

def cmd_seghaplotypes(args) -> int:
    """ngskit4b seghaplotypes equivalent (CSegHaplotypes,
    seghaplotypes.cpp:887 GenBinnedSegments): founder-tagged SAM ->
    smoothed per-founder bins -> seed + interpolation calling -> score-run
    BEDs split per founder (plus raw-alignment BEDs)."""
    from .tools.seghaps import run_seghaplotypes
    from .utils.runtime import log
    res = run_seghaplotypes(
        args.infile, args.outfile, bin_size_kbp=args.binsizekbp,
        min_bin_score=args.minbinscore, min_bin_prop=args.minbinprop,
        snp_marker_mult=args.snpmarkermult,
        unique_loci=(args.mode == 0), dont_score=args.noscore,
        no_split=args.split, snp_markers=args.snpmarkers,
        alignment_beds=args.alignbeds, track_name=args.trackname,
        track_descr=args.trackdescr)
    log.info("seghaplotypes: %d alignments, founders %s, %d bins called "
             "-> %s", res["n_alignments"], res["founders"],
             res["called_bins"], list(res["beds"]))
    return 0

def cmd_gbsmapsnps(args) -> int:
    """ngskit4b gbsmapsnps equivalent (CGBSmapSNPs)."""
    from .kmer import gbs
    from .utils.runtime import log
    if args.mode == 0:
        cmap = gbs.load_chrom_map(args.cnmap) if args.cnmap else None
        founders, progenies, rows = gbs.map_gbs_snps(args.infile, cmap)
        gbs.write_haplotype_matrix(args.outfile, founders, progenies,
                                   rows, expr_id=args.exprid)
        reports = gbs.write_progeny_reports(args.outfile, founders,
                                            progenies, rows,
                                            expr_id=args.exprid)
        log.info("gbsmapsnps: %d loci x %d progenies -> %s (+%d progeny "
                 "reports)", len(rows), len(progenies), args.outfile,
                 len(reports))
    else:
        st = gbs.combine_matrices(args.infile, args.cnmap, args.outfile)
        log.info("gbsmapsnps combine: %s -> %s", st, args.outfile)
    return 0

def cmd_dgts(args) -> int:
    """ngskit4b dgts equivalent (CDGTvQTLs): mode 0 QTL-only, mode 1
    DGT and QTL loci, classified against a reference-assembly PBA with
    coverage / homozygosity / ref-mismatch characterisation
    (CDGTvQTLs.cpp AnalyseInstance)."""
    from .kmer import dgtqtl
    from .kmer.pba import load_pba_any as load_pba
    from .utils.runtime import log
    instances = dgtqtl.load_qtl_alleles(args.qtlsfile) \
        if args.qtlsfile else []
    if args.mode >= 1 and args.dgtsfile:
        instances.extend(dgtqtl.load_dgt_loci(args.dgtsfile))
    sample_pbas = {}
    for spec in args.samplefiles:
        name = spec.split("=", 1)[0] if "=" in spec else spec
        path = spec.split("=", 1)[1] if "=" in spec else spec
        _, chroms = load_pba(path)
        sample_pbas[name] = chroms
    if args.refpba:
        _, ref = load_pba(args.refpba)
    else:
        # without an explicit reference, synthesize one from QTL refs:
        # the first sample stands in (flagged in the output semantics)
        ref = sample_pbas[next(iter(sample_pbas))]
    rows = dgtqtl.analyse_dgt_qtls(instances, ref, sample_pbas,
                                   mode=args.mode,
                                   min_coverage=args.mincovp,
                                   homoz_prop=args.homozp)
    dgtqtl.write_dgt_qtl_csv(args.outfile, rows)
    log.info("dgts: %d loci x %d samples -> %s", len(rows),
             len(sample_pbas), args.outfile)
    return 0


def cmd_locmarkers(args) -> int:
    """ngskit4b locmarkers equivalent (CLocKMers over an index's chosen
    chromosomes). The JAX package computes the markers, then fails on
    `write_markers_fasta(..., cultivar=)`, a parameter that function does
    not take (TypeError; kit4b_tpu/cli_tools.py:406 against
    kit4b_tpu/kmer/kmarkers.py:302), and writes no file. The port refuses
    before it loads the index, so that neither package writes markers
    until both are mended: `find_cultivar_markers` and
    `write_markers_fasta` without `cultivar=` are held equal at function
    level (ROADMAP.md queue C)."""
    raise ValueError(
        "locmarkers: the JAX package's locmarkers fails with TypeError "
        "after computing its markers (write_markers_fasta() takes no "
        "cultivar=; ROADMAP.md queue C, '`locmarkers` raises `TypeError`'"
        "); the port refuses likewise and writes nothing. kmarkers -t "
        "computes the same markers")



def _kalign_args(p: argparse.ArgumentParser) -> None:
    """kit4b_tpu's kalign flags, copied, plus --device."""
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-I", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--csindex", action="store_true",
                   help="write CSI index beside BAM output "
                        "(SAMfile.h:21-58 CSI variant)")
    p.add_argument("--baindex", action="store_true",
                   help="write coordinate-sorted BAM + .bai (out must be .bam)")
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
                   help="coverage WIG output")
    p.add_argument("-O", "--stats", dest="statsfile", default=None,
                   help="aligner stats CSV (substitution distribution)")
    p.add_argument("--nonealign", default=None,
                   help="write unalignable reads fasta (reference -j)")
    p.add_argument("--multialign", default=None,
                   help="write multialigned reads fasta (reference -J)")
    p.add_argument("--markerfile", default=None,
                   help="write SNP marker sequences fasta "
                        "(KAligner.cpp:7483)")
    p.add_argument("--markerlen", type=int, default=25,
                   help="marker 5'/3' flank length (cMinMarkerLen)")
    p.add_argument("--markerpolythres", type=float, default=0.333,
                   help="max marker base polymorphism proportion")
    p.add_argument("--snpcentroidfile", default=None,
                   help="write SNP centroid context CSV "
                        "(KAligner.cpp:8625)")
    p.add_argument("-Z", "--include", nargs="+", default=None,
                   help="only accept hits on chroms matching these regexes")
    p.add_argument("-z", "--exclude", nargs="+", default=None,
                   help="reject hits on chroms matching these regexes")
    p.add_argument("-B", "--priorityregions", dest="priobed", default=None,
                   help="BED: accepted hits must overlap these regions")
    p.add_argument("-5", "--pcrdups", type=int, default=0,
                   help="cap accepted reads per (loci,strand); 0 disables")
    p.add_argument("-y", "--microindellen", type=int, default=0,
                   help="microInDel rescue up to this length (0 disables)")
    p.add_argument("-l", "--splicemax", type=int, default=0,
                   help="splice junction rescue up to this gap (0 disables)")
    p.add_argument("-C", "--chimeric", type=int, default=0,
                   help="chimeric trim: min retained %% of read (0 disables)")
    p.add_argument("-3", "--pba", dest="pbafile", default=None,
                   help="Packed Base Allele output (.pba.npz; genpba mode)")
    p.add_argument("-X", "--disnp", dest="disnpfile", default=None,
                   help="DiSNP/TriSNP output prefix (requires -S)")
    p.add_argument("-p", "--minsnpreads", type=int, default=5)
    p.add_argument("-P", "--qvalue", type=float, default=0.05)
    p.add_argument("-x", "--minflankexacts", type=int, default=0,
                   help="autotrim flanks until this many exact flank bases "
                        "(0 disables; reference -x)")
    p.add_argument("-6", "--pcrprimersubs", dest="pcrprimersubs", type=int,
                   default=0,
                   help="align with subs+this allowance, then correct 5' "
                        "PCR primer artefacts over first 12bp until within "
                        "subs (reference -6)")
    p.add_argument("--lociconstraints", default=None,
                   help="loci base constraints CSV (reference -5)")
    p.add_argument("--mlmode", type=int, default=0,
                   help="multiloci reads: 0 slough, 2 rand, 3 cluster with "
                        "uniques, 4 cluster, 5 report all (reference -r)")
    p.add_argument("--bisulfite", action="store_true",
                   help="bisulfite alignment (index built with -m1; "
                        "reference -b)")
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
                   help="0 standard, 1 bisulfite (two collapsed indexes)")
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

    p = sub.add_parser("genpba",
                       help="align readsets -> Packed Base Alleles file")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-I", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True,
                   help="PBA output (.pba.npz)")
    p.add_argument("--sam", dest="samfile", default=None,
                   help="also write accepted alignments SAM")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-s", "--substitutions", type=int, default=5)
    p.add_argument("-r", "--editdelta", type=int, default=1)
    p.add_argument("-R", "--maxmulti", type=int, default=5)
    p.add_argument("-n", "--maxns", type=int, default=1)
    p.add_argument("-y", "--microindellen", type=int, default=0)
    p.add_argument("-l", "--splicemax", type=int, default=0)
    p.add_argument("-C", "--chimeric", type=int, default=0)
    p.add_argument("-p", "--minsnpreads", type=int, default=5)
    p.add_argument("-P", "--qvalue", type=float, default=0.05)
    p.add_argument("-b", "--batchsize", type=int, default=8192)
    p.add_argument("-u", "--pair", dest="pairfile", nargs="+",
                   default=None)
    p.add_argument("-U", "--pemode", type=int, default=0)
    p.add_argument("-d", "--pairminlen", type=int, default=100)
    p.add_argument("-D", "--pairmaxlen", type=int, default=1000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the passes on the card; cpu runs the "
                        "same PyTorch code on the CPU")
    _common(p)
    p.set_defaults(fn=cmd_genpba)

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

    device_help = ("cuda runs the device pass on the card; cpu runs the "
                    "same PyTorch code on the CPU")
    p = sub.add_parser("filter", help="filter reads: dedup + error reduction")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-u", "--pair", dest="pairfile", nargs="+", default=None)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-k", "--checkpoint", default=None,
                   help="packed-store checkpoint file (resume if exists)")
    p.add_argument("-Q", "--minphred", type=int, default=0)
    p.add_argument("-x", "--trim5", type=int, default=0)
    p.add_argument("-X", "--trim3", type=int, default=0)
    p.add_argument("-l", "--minlen", type=int, default=30)
    p.add_argument("-d", "--nodedup", action="store_true")
    p.add_argument("-D", "--neardup", type=int, default=0,
                   help="also remove near-duplicates within this many subs")
    p.add_argument("-y", "--minoverlap", type=int, default=70,
                   help="min flank overlap support percent")
    p.add_argument("-c", "--passes", type=int, default=1)
    p.add_argument("-a", "--adapters", action="store_true",
                   help="trim standard Illumina adapter read-through")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=device_help + " (-D only)")
    _common(p)
    p.set_defaults(fn=cmd_filter)

    p = sub.add_parser("assemb", help="de novo overlap assembly")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-u", "--pair", dest="pairfile", nargs="+", default=None,
                   help="PE2 mate files (PE-aware assembly)")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-y", "--minoverlap", type=int, default=50)
    p.add_argument("-Y", "--minoverlapfinal", type=int, default=30)
    p.add_argument("-s", "--subs", type=int, default=2,
                   help="max subs per 100bp of overlap")
    p.add_argument("-c", "--maxpasses", type=int, default=20)
    p.add_argument("-P", "--passthres", type=int, default=0,
                   help="checkpoint contigs each N passes")
    _common(p)
    p.set_defaults(fn=cmd_assemb)

    p = sub.add_parser("scaffold",
                       help="sequence-aware contig scaffolding from PE reads")
    p.add_argument("-a", "--pe1", required=True)
    p.add_argument("-A", "--pe2", required=True)
    p.add_argument("-c", "--contigs", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-L", "--minlinks", type=int, default=2)
    p.add_argument("-g", "--gap", type=int, default=100)
    p.add_argument("-p", "--insert", type=int, default=500,
                   help="PE library mean insert size")
    p.add_argument("-s", "--subs", type=int, default=5)
    p.add_argument("--minctg", type=int, default=0,
                   help="minimum contig length to scaffold")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=device_help + " (kalign of the mates)")
    _common(p)
    p.set_defaults(fn=cmd_scaffold)

    p = sub.add_parser("pescaffold", help="scaffold contigs from PE SAMs")
    p.add_argument("-a", "--pe1sam", required=True)
    p.add_argument("-A", "--pe2sam", required=True)
    p.add_argument("-c", "--contigs", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-L", "--minlinks", type=int, default=2)
    p.add_argument("-g", "--gap", type=int, default=100)
    _common(p)
    p.set_defaults(fn=cmd_pescaffold)

    p = sub.add_parser("mergeoverlaps",
                       help="merge overlapping PE pairs into SE reads")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-u", "--pair", dest="pairfile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-j", "--unmerged1", default=None)
    p.add_argument("-J", "--unmerged2", default=None)
    p.add_argument("-y", "--minoverlap", type=int, default=16)
    p.add_argument("-s", "--subs", type=int, default=5)
    _common(p)
    p.set_defaults(fn=cmd_mergeoverlaps)

    p = sub.add_parser("rnaexpr",
                       help="RNA replicate consistency (Pearson matrix)")
    p.add_argument("-i", "--cntsfile", dest="infile", required=True,
                   help="expression counts matrix CSV")
    p.add_argument("-c", "--samplesfile", default=None,
                   help="sample -> partner replicate CSV (default: "
                        "adjacent pairing)")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=device_help + " (the Pearson matmul)")
    _common(p)
    p.set_defaults(fn=cmd_rnaexpr)

    p = sub.add_parser("genmlds",
                       help="transpose feature CSV into ML dataset")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-l", "--labels", default=None,
                   help="sample,label CSV to join")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_genmlds)

    p = sub.add_parser("sarscov2ml",
                       help="feature linkage discovery over a matrix")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-l", "--numlinkedfeatures", type=int, default=5)
    p.add_argument("-r", "--minlinkedrows", type=int, default=50)
    p.add_argument("-c", "--featclassvalue", type=int, default=3)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=device_help + " (the co-support matmul)")
    _common(p)
    p.set_defaults(fn=cmd_sarscov2ml)

    sw_help = device_help + " (the banded Smith-Waterman batches)"
    p = sub.add_parser("ecreads",
                       help="error correct PacBio long reads (pacbiokit4b)")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-l", "--minreadlen", type=int, default=1000)
    p.add_argument("-L", "--mincorrectedlen", type=int, default=500)
    p.add_argument("-b", "--band", type=int, default=512)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=sw_help)
    _common(p)
    p.set_defaults(fn=cmd_ecreads)

    p = sub.add_parser("pbfilter",
                       help="filter PacBio reads for SMRTbell hairpins")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-l", "--minlen", type=int, default=500)
    p.add_argument("-t", "--trim", type=int, default=0)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=sw_help)
    _common(p)
    p.set_defaults(fn=cmd_pbfilter)

    p = sub.add_parser("pbassemb",
                       help="assemble corrected PacBio reads into contigs")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-l", "--minoverlap", type=int, default=500)
    p.add_argument("-p", "--minidentity", type=float, default=0.9)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=sw_help)
    _common(p)
    p.set_defaults(fn=cmd_pbassemb)

    p = sub.add_parser("eccontigs",
                       help="error correct contigs with corrected reads")
    p.add_argument("-i", "--in", dest="infile", required=True,
                   help="contigs multifasta")
    p.add_argument("-r", "--reads", required=True,
                   help="corrected reads multifasta")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=sw_help)
    _common(p)
    p.set_defaults(fn=cmd_eccontigs)

    p = sub.add_parser("kmerdist",
                       help="exact K-mer distributions from MAF")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-K", "--maxk", type=int, default=16)
    _common(p)
    p.set_defaults(fn=cmd_kmerdist)

    p = sub.add_parser("blitz", help="local-align long queries vs index")
    p.add_argument("-G", "--gapped", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="refine chained blocks with banded affine SW — "
                        "the reference's path polish always runs "
                        "HighScoreSW (CBlitz.cpp:1560), so gapped is the "
                        "default; --no-gapped keeps ungapped chains")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-I", "--sfx", dest="sfxfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True,
                   help="PSL output")
    p.add_argument("-s", "--stride", type=int, default=4)
    p.add_argument("-c", "--minhits", type=int, default=3)
    p.add_argument("-b", "--band", type=int, default=12)
    p.add_argument("-m", "--minscore", type=int, default=50)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help=sw_help)
    _common(p)
    p.set_defaults(fn=cmd_blitz)

    p = sub.add_parser("hrdx",
                       help="homozygotic-region reduction of diploid "
                            "assemblies")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-z", "--maxhomozysubs", type=int, default=3)
    p.add_argument("-Z", "--minhomozylen", type=int, default=75)
    p.add_argument("-k", "--minhetrozylen", type=int, default=30)
    p.add_argument("-L", "--minctglen", type=int, default=100)
    _common(p)
    p.set_defaults(fn=cmd_hrdx)

    p = sub.add_parser("benchmark",
                       help="MAGIC benchmark: limit/gencigars/simreads/"
                            "score (Benchmarker.h modes)")
    p.add_argument("-m", "--mode", type=int, default=4,
                   help="0 limitreads, 1 gencigars, 2 simreads, 3 score "
                        "vs MAGIC ground truth, 4 simreads-descriptor "
                        "scorer")
    p.add_argument("-i", "--in", dest="infile", default=None,
                   help="input SAM (modes 1/3/4) or raw reads (mode 0)")
    p.add_argument("-o", "--out", dest="outfile", default=None,
                   help="output reads (modes 0/2) or JSON (modes 3/4)")
    p.add_argument("-t", "--tolerance", type=int, default=0)
    p.add_argument("--refgenome", default=None,
                   help="target genome fasta (modes 1/2)")
    p.add_argument("--cigarsfile", default=None,
                   help="observed CIGARs CSV (written mode 1, read mode 2)")
    p.add_argument("--groundtruth", default=None,
                   help="simulated reads fasta with ground truth (mode 3)")
    p.add_argument("--outpe2", default=None,
                   help="PE2 output reads (mode 2) / PE2 truth (mode 3)")
    p.add_argument("--pe", action="store_true")
    p.add_argument("--maxreads", type=int, default=2_000_000)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("-j", "--fbetabases", type=float, default=0.1)
    p.add_argument("-J", "--fbetareads", type=float, default=0.1)
    _common(p)
    p.set_defaults(fn=cmd_benchmark)

    p = sub.add_parser("alignsbs", help="alignment bootstrapper")
    p.add_argument("-p", "--queryseqsfile", required=True)
    p.add_argument("-P", "--queryassembfile", required=True)
    p.add_argument("-i", "--targseqsfile", required=True)
    p.add_argument("-I", "--targassembfile", required=True)
    p.add_argument("-b", "--numbootstraps", type=int, default=100)
    p.add_argument("-s", "--maxsubs", type=int, default=0,
                   help="max subs per 100bp of query")
    p.add_argument("-r", "--randseed", type=int, default=0)
    p.add_argument("-a", "--senseonly", action="store_true")
    p.add_argument("-o", "--qrsltsfile", required=True)
    p.add_argument("-O", "--trsltsfile", required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the aligner's passes on the card; cpu "
                        "runs the same PyTorch code on the CPU")
    _common(p)
    p.set_defaults(fn=cmd_alignsbs)

    p = sub.add_parser("ngsqc", help="readset QC distributions")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outprefix", required=True,
                   help="output file prefix")
    p.add_argument("-K", "--kmerlen", type=int, default=5)
    p.add_argument("-H", "--contaminants", default=None,
                   help="contaminant fasta ('-' = builtin Illumina "
                        "adapters); writes <out>.contaminants.csv")
    p.add_argument("-z", "--maxcontamsubrate", type=int, default=1,
                   help="contaminant subs per 25bp of overlap (0..3)")
    p.add_argument("-Z", "--mincontamlen", type=int, default=5,
                   help="min contaminant overlap bases")
    p.add_argument("--plots", action="store_true",
                   help="render QC plot PNGs (libBKPLPlot parity; needs "
                        "matplotlib)")
    _common(p)
    p.set_defaults(fn=cmd_ngsqc)

    p = sub.add_parser("maploci", help="map aligned loci onto BED features")
    p.add_argument("-i", "--in", dest="infile", required=True,
                   help="SAM input")
    p.add_argument("-b", "--bed", dest="bedfile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_maploci)

    p = sub.add_parser("rnade",
                       help="RNA-seq differential expression (CRNA_DE)")
    p.add_argument("-i", "--control", nargs="+", required=True,
                   help="control read alignment files (SAM/BED/CSV)")
    p.add_argument("-I", "--experiment", nargs="+", required=True,
                   help="experiment read alignment files")
    p.add_argument("-g", "--ingene", dest="bedfile", required=True,
                   help="gene/feature BED")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-O", "--bincounts", default=None,
                   help="per-feature bin counts CSV")
    p.add_argument("-b", "--numbins", type=int, default=10)
    p.add_argument("-C", "--minfeatcnts", type=int, default=10)
    p.add_argument("-r", "--region", type=int, default=1,
                   help="0 transcript, 1 exons, 2 introns, 3 CDS, "
                        "4 UTRs, 5 5'UTR, 6 3'UTR")
    p.add_argument("-s", "--alignstrand", type=int, default=0)
    p.add_argument("-S", "--featstrand", type=int, default=0)
    p.add_argument("-c", "--cowinlen", type=int, default=1)
    p.add_argument("-a", "--artifactthres", type=int, default=20)
    p.add_argument("-n", "--normcnts", type=float, default=0.0)
    p.add_argument("--minstartloci", type=int, default=5)
    p.add_argument("-A", "--nonalign", action="store_true")
    p.add_argument("-x", "--excludezones", default=None)
    p.add_argument("-L", "--limitaligned", type=int, default=0)
    _common(p)
    p.set_defaults(fn=cmd_rnade)

    p = sub.add_parser("callhaplotypes",
                       help="founder/progeny haplotype calls + grouping")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 imputed matrix, 1 +raw matrices, 2 +GWAS, "
                        "3 allelic grouping, 4 coverage grouping, "
                        "5 group DGTs, 6 WIG, 7 src-vs-refs scores, "
                        "8 refs-vs-refs scores, 9 grouping by scores, "
                        "10 group KMers, 11 filter scores, "
                        "12 filter+transform scores")
    p.add_argument("-i", "--progeny", dest="progeny_list", nargs="+",
                   default=None, metavar="[NAME=]pba",
                   help="progeny/source PBA(s)")
    p.add_argument("-c", "--founder", nargs="*", default=[],
                   metavar="NAME=pba",
                   help="founder/reference PBAs (two for modes 0-2)")
    p.add_argument("-A", "--allelescorefile", default=None,
                   help="scores CSV from mode 7/8 (modes 9/11/12)")
    p.add_argument("--minunprunedrefs", type=int, default=1,
                   help="mode 9: prune while >= this many refs remain")
    p.add_argument("-P", "--maxunprunedrefs", type=int, default=4,
                   help="mode 9: prune until <= this many refs remain")
    p.add_argument("-r", "--filtsrcpbascores", nargs="*", default=[],
                   help="modes 11/12: retain source PBA name regexes")
    p.add_argument("-R", "--filtrefpbascores", nargs="*", default=[],
                   help="modes 11/12: retain reference PBA name regexes")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-b", "--binsize", type=int, default=10_000)
    p.add_argument("--minloci", type=int, default=5)
    p.add_argument("--wwrlproxwindow", type=int, default=1_000_000,
                   help="Wald-Wolfowitz runs-test proximal window "
                        "(0 disables het imputation)")
    p.add_argument("-C", "--chrom", default=None,
                   help="grouping modes: process this chromosome")
    p.add_argument("-a", "--affinegaplen", type=int, default=3)
    p.add_argument("-g", "--grphapbinsize", type=int, default=0,
                   help="grouping bin size (0 = one bin per chrom)")
    p.add_argument("-G", "--maxclustgrps", type=int, default=5)
    p.add_argument("-p", "--gpphases", type=int, default=10)
    p.add_argument("-d", "--mincentclustdist", type=int, default=5)
    p.add_argument("-D", "--maxcentclustdist", type=int, default=10_000)
    p.add_argument("-n", "--grpdgtmbrs", type=int, default=10)
    p.add_argument("--grpdgtsamples", type=float, default=0.10)
    p.add_argument("-Q", "--grpdgtfmeasure", type=float, default=0.90)
    p.add_argument("-N", "--maxreportgrpdgts", type=int,
                   default=10_000_000)
    p.add_argument("-k", "--kmersize", type=int, default=25)
    p.add_argument("-K", "--minkmerhamming", type=int, default=2)
    p.add_argument("-U", "--kmernonecoverage", type=int, default=0)
    _common(p)
    p.set_defaults(fn=cmd_callhaplotypes)

    p = sub.add_parser("snpmarkers",
                       help="cross-cultivar SNP-derived markers")
    p.add_argument("-c", "--cultivar", nargs="+", required=True,
                   metavar="NAME=snps.csv")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-m", "--mincov", type=int, default=5)
    p.add_argument("-p", "--purity", type=float, default=80.0,
                   help="min major-allele percent")
    _common(p)
    p.set_defaults(fn=cmd_snpmarkers)

    p = sub.add_parser("pbautils", help="PBA utilities (pbautils.cpp)")
    p.add_argument("-m", "--mode", required=True,
                   choices=["0", "1", "2", "3", "4", "5", "6", "7", "8",
                            "concat", "coverage"],
                   help="0 PBA->fasta, 1 fasta->PBA, 2/3 concordance, "
                        "4 allelic VCF, 5/6/7 genotype VCFs, 8 BED")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-r", "--refpba", default=None,
                   help="reference assembly PBA (modes 4-7)")
    p.add_argument("--gtpropna", type=float, default=0.5)
    p.add_argument("--gtprophet", type=float, default=0.0)
    _common(p)
    p.set_defaults(fn=cmd_pbautils)

    p = sub.add_parser("snps2pgsnps",
                       help="kalign SNP CSV -> UCSC pgSnp (or .vcf)")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-t", "--track", default="kit4b_tpu")
    p.add_argument("-c", "--mincount", type=int, default=1)
    _common(p)
    p.set_defaults(fn=cmd_snps2pgsnps)

    p = sub.add_parser("lochap2bed",
                       help="Di/TriSNP local haplotypes CSV -> BED")
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_lochap2bed)

    p = sub.add_parser("markerseqs",
                       help="marker flank sequences around SNP loci")
    p.add_argument("-i", "--in", dest="infile", required=True,
                   help="kalign SNP CSV")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-l", "--flank", type=int, default=25)
    _common(p)
    p.set_defaults(fn=cmd_markerseqs)

    p = sub.add_parser("repassemb",
                       help="replace assembly bases with SNP major alleles")
    p.add_argument("-i", "--in", dest="infile", required=True,
                   help="kalign SNP CSV")
    p.add_argument("-g", "--genome", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    p.add_argument("-p", "--minprop", type=float, default=0.5)
    _common(p)
    p.set_defaults(fn=cmd_repassemb)

    p = sub.add_parser("pangenome",
                       help="founder-tagged pangenome processing")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 prefix fasta, 1 filter SAM by prefix, "
                        "2 wiggle all, 3 wiggle unique loci")
    p.add_argument("-p", "--prefix", default="",
                   help="founder/descriptor prefix")
    p.add_argument("-b", "--binsizekbp", type=int, default=10)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_pangenome)

    p = sub.add_parser("seghaplotypes",
                       help="pangenome founder segment calling -> BED")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 unique loci bins, 1 all alignments")
    p.add_argument("-s", "--split", action="store_true",
                   help="don't split output files by haplotype tag")
    p.add_argument("-n", "--noscore", action="store_true",
                   help="don't score haplotype segment bins")
    p.add_argument("-b", "--binsizekbp", type=int, default=10)
    p.add_argument("--minbinscore", type=int, default=10)
    p.add_argument("-M", "--minbinprop", type=float, default=0.3)
    p.add_argument("-c", "--snpmarkermult", type=int, default=25)
    p.add_argument("-I", "--snpmarkers", default=None,
                   help="snpmarkers CSV (SNP marker loci association)")
    p.add_argument("--alignbeds", action="store_true",
                   help="also write per-founder raw-alignment BEDs")
    p.add_argument("-t", "--trackname", default="seghaps")
    p.add_argument("-d", "--trackdescr", default="founder segments")
    p.add_argument("-i", "--in", dest="infile", nargs="+", required=True)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_seghaplotypes)

    p = sub.add_parser("gbsmapsnps",
                       help="GBS SNP calls -> founder haplotype matrix")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 map SNPs to haplotypes, 1 combine matrices")
    p.add_argument("-e", "--exprid", type=int, default=1)
    p.add_argument("-i", "--in", dest="infile", required=True,
                   help="-m0: GBS SNP CSV; -m1: matrix M1")
    p.add_argument("-I", "--cnmap", default=None,
                   help="-m0: chrom name map CSV; -m1: matrix M2")
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_gbsmapsnps)

    p = sub.add_parser("dgts", help="DGT/QTL allele analysis over PBAs")
    p.add_argument("-m", "--mode", type=int, default=0,
                   help="0 QTL-only, 1 DGT and QTL loci")
    p.add_argument("-Q", "--qtlsfile", default=None,
                   help="QTL alleles CSV (chrom,loci,ref[,alt])")
    p.add_argument("-D", "--dgtsfile", default=None,
                   help="DGT loci CSV (callhaplotypes mode 5 output)")
    p.add_argument("-I", "--refpba", default=None,
                   help="reference assembly PBA (pbautils -m1 output)")
    p.add_argument("-i", "--samplefiles", nargs="+", required=True,
                   help="sample PBA files (name=path or path)")
    p.add_argument("-k", "--mincovp", type=float, default=0.8)
    p.add_argument("-p", "--homozp", type=float, default=0.95)
    p.add_argument("-o", "--out", dest="outfile", required=True)
    _common(p)
    p.set_defaults(fn=cmd_dgts)

    p = sub.add_parser("locmarkers", help="cultivar marker K-mers")
    p.add_argument("-m", "--mode", type=int, default=0)
    p.add_argument("-k", "--kmer", type=int, default=50)
    p.add_argument("-K", "--minhamming", type=int, default=2)
    p.add_argument("-c", "--cultivar", required=True)
    p.add_argument("-C", "--chromnames", required=True)
    p.add_argument("-i", "--in", dest="infile", required=True)
    p.add_argument("-o", "--markers", dest="outfile", required=True)
    p.add_argument("-O", "--markerreads", default=None)
    _common(p)
    p.set_defaults(fn=cmd_locmarkers)
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
