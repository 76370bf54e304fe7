"""Command-line entry of the PyTorch/CUDA port: `python -m kit4b_tpu_torch`.

Port of kit4b_tpu/cli.py with the `index`, `kalign` and `hammings`
subcommands, taking the same flags and writing the same files, plus
`--device {cuda,cpu}` on the commands that use a device. The parsers are
copies, as is all the port needs of the JAX package: it imports none of
it. Flags of paths not ported yet parse as in kit4b_tpu and raise
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
    "pairfile": ("-u (paired ends)", 13), "pemode": ("-U", 13),
    "microindellen": ("-y", 12), "splicemax": ("-l", 12),
    "chimeric": ("-C", 12), "mlmode": ("--mlmode", 20),
    "bisulfite": ("--bisulfite", 17), "csindex": ("--csindex (BAM)", 20),
    "baindex": ("--baindex (BAM)", 20), "include": ("-Z", 20),
    "exclude": ("-z", 20), "priobed": ("-B", 20), "pcrdups": ("-5", 20),
    "wigfile": ("-g", 20), "nonealign": ("--nonealign", 20),
    "multialign": ("--multialign", 20), "markerfile": ("--markerfile", 20),
    "snpcentroidfile": ("--snpcentroidfile", 20), "pbafile": ("-3", 20),
    "disnpfile": ("-X", 20), "minflankexacts": ("-x", 20),
    "pcrprimersubs": ("-6", 20), "lociconstraints": ("--lociconstraints", 20),
}


def cmd_kalign(args) -> int:
    """ngskit4b kalign equivalent (KAlignerCL.cpp / KAligner.cpp): SE,
    substitutions only, SAM through the native formatter."""
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
                         sens=sens, device=device)
    caller = None
    if args.snpfile:
        from .align import snp     # imports scipy: only for -S
        caller = snp.SnpCaller(idx.genome, snp.SnpOptions(
            min_snp_reads=args.minsnpreads, qvalue=args.qvalue))

    def stream(paths):
        for path in paths:
            yield from read_seqs(path)

    src = args.infile[0] if len(args.infile) == 1 else stream(args.infile)
    with t.phase("align"):
        stats = kalign.write_sam_fast(
            args.outfile, idx, al, src, cmdline=" ".join(sys.argv),
            emit_unmapped=(args.format == 1), snp_caller=caller,
            stats_path=args.statsfile)
    log.info("kalign: %d reads, %s; tier 1 by read length %s on %s",
             sum(stats.values()), stats,
             {L: "v5" if v5 else "v4"
              for L, v5 in al._lut4_decided.items()}, device)
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
    if args.restricted:
        raise NotImplementedError("hammings -r (restricted mode) is not "
                                  "ported yet: ROADMAP.md queue A item 11")
    if args.ring or args.mesh:
        raise NotImplementedError("hammings -M/-R (multi-device) is not "
                                  "ported yet: ROADMAP.md queue A item 10")
    device = resolve(args.device)
    t = PhaseTimer()
    with t.phase("load genome"):
        g = Genome.load(infiles[0])
    with t.phase("sweep"):
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
                   help="PE mate-2 input files (not ported yet)")
    p.add_argument("-U", "--pemode", type=int, default=0,
                   help="PE mode (not ported yet)")
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
                   help="pigeonhole mode bound (not ported yet); "
                        "0 = exhaustive")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda runs the hand kernels; cpu runs their plain "
                        "PyTorch versions")
    _common(p)
    p.set_defaults(fn=cmd_hammings)
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
