"""Command-line entry of the PyTorch/CUDA port: `python -m kit4b_tpu_torch`.

Port of kit4b_tpu/cli.py with the `hammings` subcommand only, taking the
same flags and writing the same files, plus `--device {cuda,cpu}`.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from .device import DeviceUnavailable, resolve


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


def cmd_hammings(args) -> int:
    """ngskit4b hammings equivalent (hammings.cpp; mode enum :99-106)."""
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.utils.runtime import PhaseTimer, log

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


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="kit4b_tpu_torch", fromfile_prefix_chars="@",
        description="PyTorch/CUDA port of the kit4b_tpu toolkit")
    sub = ap.add_subparsers(dest="cmd", required=True)

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
    from kit4b_tpu.utils.runtime import setup_logging
    args = build_parser().parse_args(argv)
    setup_logging(args.loglevel, args.logfile)
    t0 = time.time()
    summ = None
    if args.sumrslts:
        from kit4b_tpu.utils.summaries import Summaries

        from . import __version__
        summ = Summaries(args.sumrslts, args.experimentname,
                         args.experimentdescr, process=args.cmd,
                         version=__version__)
        summ.params(**{k: v for k, v in vars(args).items()
                       if k not in ("fn",) and v is not None})
    try:
        rc = args.fn(args)
    except (FileNotFoundError, ValueError, NotImplementedError,
            DeviceUnavailable) as e:
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
