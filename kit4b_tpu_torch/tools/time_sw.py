"""Times the banded Smith-Waterman kernels at the shapes their callers give
them.

    python -m kit4b_tpu_torch.tools.time_sw [--layouts]

Three seeded batches, each as `banded_sw_batch` pads it (probes and
targets to multiples of 512 with 0x0F):

    ecreads   B 32, Lp 4,096, W 3,000: CLR reads (tools.pacbio_reads'
              corruption) of overlapping genome windows on their true
              diagonal, ecreads' scores (`ecreads -b 3000`)
    pbassemb  B 32, Lp 16,384, W 256: corrected reads of about 16 kbp
              (1 % insertions, 1 % deletions, 0.2 % substitutions) that
              overlap, pbassemb's scores
    pbfilter  B 16, Lp 16,384, W 512: hairpin reads (a CLR subread and
              the reverse complement of another of the same window)
              against their own reverse complement on diagonal 0,
              pbfilter's scores

For each it launches the scan once (build and warm-up), then times five
scans and five tracebacks with CUDA events, one launch each, and prints
one JSON line with the runs, their medians and the walks' op counts (the
traceback's bytes bound reads them). With `--layouts` it also times the
scan at every cluster size and columns a thread that `sw.scan_layouts`
lists for the shape.

To time another checkout's kernels on the same batches, run this file by
its path with `PYTHONPATH` set to that checkout's root: the wrappers'
contract (`kernels/sw.py`) is the same.
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

SEED = 20240626          # chip_smoke.py's SEED + 15: phase 15b's batch
SCORES = {"ecreads": (1, -2, -2, -1), "pbassemb": (1, -3, -4, -2),
          "pbfilter": (1, -2, -2, -1)}


def _revcomp(codes: np.ndarray) -> np.ndarray:
    rev = codes[::-1]
    return np.where(rev < 4, 3 - rev, rev).astype(np.uint8)


def batch_ecreads(rng):
    """32 pairs of CLR reads of overlapping windows of one genome, probes
    of about 3,900 bases in a width of 4,096, on their true diagonal in a
    band of 3,000."""
    from kit4b_tpu_torch.tools.pacbio_reads import corrupt_pacbio
    B, Lp, W = 32, 4096, 3000
    genome = rng.integers(0, 4, 12_000).astype(np.uint8)
    probes = np.full((B, Lp), 0x0F, np.uint8)
    targets = np.full((B, Lp), 0x0F, np.uint8)
    plens, tlens, diag0 = (np.zeros(B, np.int32) for _ in range(3))
    for b in range(B):
        s = int(rng.integers(0, 8_000))
        s2 = int(np.clip(s + rng.integers(-1_500, 1_500), 0, 8_000))
        p = corrupt_pacbio(genome[s:s + 3_600], rng)[:Lp]
        t = corrupt_pacbio(genome[s2:s2 + 3_600], rng)[:Lp]
        probes[b, :len(p)], targets[b, :len(t)] = p, t
        plens[b], tlens[b], diag0[b] = len(p), len(t), s - s2
    return probes, plens, targets, tlens, diag0, W, SCORES["ecreads"]


def batch_pbassemb(rng):
    """32 pairs of overlapping corrected reads of about 16 kbp in a band
    of 256."""
    from kit4b_tpu_torch.tools.pacbio_reads import corrupt_pacbio
    B, W = 32, 256
    genome = rng.integers(0, 4, 40_000).astype(np.uint8)
    probes, targets = [], []
    plens, tlens, diag0 = (np.zeros(B, np.int32) for _ in range(3))
    for b in range(B):
        s = int(rng.integers(0, 20_000))
        s2 = int(np.clip(s + rng.integers(-4_000, 4_000), 0, 24_000))
        kw = dict(ins=0.01, dele=0.01, sub=0.002)
        probes.append(corrupt_pacbio(genome[s:s + 16_000], rng, **kw))
        targets.append(corrupt_pacbio(genome[s2:s2 + 16_000], rng, **kw))
        plens[b], tlens[b] = len(probes[-1]), len(targets[-1])
        diag0[b] = s - s2
    return (*_stack(probes, plens), *_stack(targets, tlens), diag0, W,
            SCORES["pbassemb"])


def batch_pbfilter(rng):
    """16 hairpin reads of about 15.9 kbp against their reverse complement
    on diagonal 0 in a band of 512."""
    from kit4b_tpu_torch.tools.pacbio_reads import corrupt_pacbio
    B, W = 16, 512
    genome = rng.integers(0, 4, 20_000).astype(np.uint8)
    reads = []
    for _ in range(B):
        s = int(rng.integers(0, 12_000))
        win = genome[s:s + 7_500]
        reads.append(np.concatenate([corrupt_pacbio(win, rng),
                                     _revcomp(corrupt_pacbio(win, rng))]))
    lens = np.array([len(r) for r in reads], np.int32)
    probes, _ = _stack(reads, lens)
    targets, _ = _stack([_revcomp(r) for r in reads], lens)
    return (probes, lens, targets, lens.copy(), np.zeros(B, np.int32), W,
            SCORES["pbfilter"])


def _stack(seqs, lens):
    out = np.full((len(seqs), int(max(lens))), 0x0F, np.uint8)
    for b, s in enumerate(seqs):
        out[b, :len(s)] = s
    return out, lens


BATCHES = {"ecreads": batch_ecreads, "pbassemb": batch_pbassemb,
           "pbfilter": batch_pbfilter}


def padded(probes, targets):
    """probes and targets padded to multiples of 512 with 0x0F, as
    banded_sw_batch pads them."""
    out = []
    for a in (probes, targets):
        m = -(-max(a.shape[1], 1) // 512) * 512
        out.append(np.pad(a, ((0, 0), (0, m - a.shape[1])),
                          constant_values=0x0F))
    return out


def on_card(torch, batch, dev):
    """The batch's (probes, targets, plens, tlens, diag0) on `dev`, padded,
    and its W and score keywords."""
    probes, plens, targets, tlens, diag0, W, (m, mm, go, ge) = batch
    pp, tp = padded(probes, targets)
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        pp, tp, np.asarray(plens, np.int32), np.asarray(tlens, np.int32),
        np.asarray(diag0, np.int32))]
    return t, dict(W=W, match=m, mismatch=mm, gap_open=go, gap_ext=ge)


def time_ms(torch, fn) -> float:
    """Milliseconds of one call of fn, by CUDA events."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def time_batch(torch, sw, batch, dev, runs=5) -> dict:
    """The scan's and the traceback's runs (sorted ms) and medians on one
    batch, and the walks' op counts."""
    (p, t, pl, tl, d0), kw = on_card(torch, batch, dev)
    W = kw["W"]
    L_OPS = p.shape[1] + W
    best, bi, bk, ptrs = sw.sw_scan(p, t, pl, tl, d0, **kw)

    def trace():
        return sw.sw_traceback(ptrs, p, t, best, bi, bk, d0, W=W,
                               L_OPS=L_OPS)
    res = trace()
    scan = sorted(time_ms(torch, lambda: sw.sw_scan(p, t, pl, tl, d0, **kw))
                  for _ in range(runs))
    tb = sorted(time_ms(torch, trace) for _ in range(runs))
    n, nm, nmm = (x.cpu().numpy() for x in (res[1], res[4], res[5]))
    return dict(B=p.shape[0], Lp=p.shape[1], Lt=t.shape[1], W=W,
                L_OPS=L_OPS, scan_runs=scan, scan_ms=scan[runs // 2],
                tb_runs=tb, tb_ms=tb[runs // 2], walk_ops=int(n.sum()),
                walk_longest=int(n.max()), walk_m=int(nm.sum() + nmm.sum()),
                n=n, nm=nm, nmm=nmm)


def time_layouts(torch, sw, batch, dev, runs=3) -> list[dict]:
    """The scan's median ms at each (cluster size, columns a thread) of
    `sw.scan_layouts` for the batch's shape."""
    (p, t, pl, tl, d0), kw = on_card(torch, batch, dev)
    out = []
    for P, C in sw.scan_layouts(kw["W"]):
        def scan():
            return sw.sw_scan(p, t, pl, tl, d0, layout=(P, C), **kw)
        scan()
        ms = sorted(time_ms(torch, scan) for _ in range(runs))
        out.append(dict(P=P, C=C, ms=ms[runs // 2], runs=ms))
    return out


def main(argv=None) -> int:
    import torch
    from kit4b_tpu_torch.kernels import sw
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("time_sw: CUDA is not available; this tool times the card's "
              "kernels", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    for name, make in BATCHES.items():
        batch = make(rng)
        row = time_batch(torch, sw, batch, dev)
        for k in ("n", "nm", "nmm"):
            del row[k]
        print(json.dumps({"shape": name, **row}))
        if "--layouts" in argv:
            for lay in time_layouts(torch, sw, batch, dev):
                print(json.dumps({"shape": name, **lay}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
