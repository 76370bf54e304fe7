"""The seeded workload of the kalign options golden file and the arrays it
holds: the post-alignment phases, the filters, BAM/BAI/CSI, the SNP side
outputs, `genpba` and bisulfite alignment, each through the CLI.

`kit4b_tpu_torch/data/kalign_opts_golden.npz` holds the JAX package's
answers on this workload; `python tests/test_torch_kalign_opts_golden.py`
regenerates it (JAX on the CPU). A machine without JAX rebuilds the same
inputs with `workload()` (numpy and the port's own host modules), runs the
port's CLI with `compute(port_main(), ["--device", device], ...)` and
compares: that is how the
port is held to the JAX package on the card.

The workload (`workload()`): two chromosomes of 120 and 80 kbp with a
400 bp unit planted four times (three on chr1, one on chr2) and a 250 bp
unit twice (once on each), and an N run. Single-end reads of 100 bp:
simreads reads (Illumina-skewed 1 % substitutions); 30 reads inside the
400 bp unit (multi over four loci) with 15 unique reads stacked over the
left edge of its first copy (so --mlmode 3 places the multi reads there)
and 12 inside the 250 bp unit with 6 reads over the left edge of each copy
(tied: --mlmode 3 leaves them); reads with 3-4 mismatches in the first 12
bases and 2-3 more (-6: some reach the rate, some cannot); reads with
mismatched 5', 3' or both flanks and one whose mismatches every 10 bases
leave no exact run to trim to (-x); stacks of duplicates on both strands
(-5); 600 reads from a 3 kbp region of chr2 carrying 12 SNPs in pairs
and triples, 20x deep (-S, -X, --markerfile, --snpcentroidfile); a
priority BED with a feature that ends exactly at a stack's start (-B); a
constraints CSV (--lociconstraints); 96 bisulfite-converted reads of
100 bp (the conversion rule of tests/test_bisulfite.py, `bis_convert`);
and 200 pairs of 2 x 100 bp for the paired-end route.

The file holds, per flag group (`GROUPS`): the SHA-256 of each output file
the run writes (the @PG line fixed to `CMDLINE`), the SAM records' flag,
position, MAPQ and the SHA-256 of the record stream, the class counts per
nar (-O), and for BAM: the SHA-256 of the decompressed payload, the BAI or
CSI decoded with its virtual offsets mapped to record ordinals, and the
raw BAM and index bytes' SHA-256 beside `zlib.ZLIB_RUNTIME_VERSION`, which
they depend on; the bisulfite index's arrays' SHA-256; and the SHA-256 of
the inputs.
"""
from __future__ import annotations

import contextlib
import hashlib
import struct
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np

from .. import dna
from ..io.bam import read_bgzf
from ..io.fasta import Genome, SeqRecord, write_fasta
from ..sim import simreads

GOLDEN = Path(__file__).resolve().parent.parent / "data" / \
    "kalign_opts_golden.npz"
SEED = 9099
CHR_LENS = (120_000, 80_000)
L = 100
UNIT_A = (400, ((0, 10_000), (0, 40_000), (0, 70_000), (1, 20_000)))
UNIT_B = (250, ((0, 90_000), (1, 50_000)))
N_RUN = (0, 100_000, 50)
SNP_REGION = (1, 30_000, 3_000)      # chromosome, start, length
SNP_OFFSETS = (120, 160, 190, 600, 640, 1100, 1130, 1800, 1850, 1880,
               2300, 2340)           # within the region; 2 heterozygous
HET = (1100, 2300)
DUP_STACKS = ((0, 30_000, 0, 5), (0, 31_000, 1, 4), (1, 10_000, 1, 3))
BATCH = 256
CMDLINE = ["kit4b", "opts-golden"]
# flag group -> kalign flags; {d} is the run's directory
S = ["-O", "{d}/stats.csv"]
GROUPS = {
    "x": ["-x", "10", "-M", "1", *S],
    "p6": ["-s", "2", "-6", "4", "-M", "1", *S],
    "x6": ["-s", "2", "-6", "4", "-x", "10", *S],
    "ml2": ["--mlmode", "2", "-M", "1", *S, "--nonealign", "{d}/na.fa",
            "--multialign", "{d}/ml.fa"],
    "ml3": ["--mlmode", "3", *S, "--multialign", "{d}/ml.fa"],
    "ml4": ["--mlmode", "4", *S],
    "ml5": ["--mlmode", "5", *S],
    "cons": ["--lociconstraints", "{d}/cons.csv", *S],
    "Z": ["-Z", "chr2", *S],
    "z": ["-z", "2$", "-M", "1", *S],
    "B": ["-B", "{d}/prio.bed", *S],
    "p5": ["-5", "2", *S],
    "bam": ["-o", "{d}/out.bam", "-M", "1", *S],
    "bai": ["-o", "{d}/out.bam", "--baindex", *S],
    "csi": ["-o", "{d}/out.bam", "--csindex", "-M", "1"],
    "snp": ["-S", "{d}/snps.csv", "-g", "{d}/cov.wig", "-3",
            "{d}/out.pba.npz", "-X", "{d}/dsnp", "--markerfile", "{d}/m.fa",
            "--snpcentroidfile", "{d}/c.csv"],
    "vcf": ["-S", "{d}/snps.vcf", "-y", "10", "-p", "4"],
    "all": ["-x", "10", "-6", "2", "--mlmode", "3", "-Z", "chr1", "-5", "4",
            "-o", "{d}/out.bam", "--baindex", "-S", "{d}/snps.csv", *S],
    "pe": ["-u", "{d}/r2.fa", "-U", "1", "-x", "10", "-5", "2", "--mlmode",
           "2", "-g", "{d}/cov.wig", "-3", "{d}/out.pba.npz"],
}
GENPBA = ["--sam", "{d}/out.sam"]
BISULFITE = ["--bisulfite", "-M", "1"]


def bis_convert(frag, strand, rng, meth_rate=0.2):
    """Bisulfite chemistry, the rule of tests/test_bisulfite.py: on the
    sequenced strand unmethylated Cs read as T. frag is watson-orientation
    genome sequence."""
    if strand == 0:
        r = frag.copy()
    else:
        r = dna.revcomp(frag)          # crick strand sequence
    c = r == 1
    conv = c & (rng.random(len(r)) > meth_rate)
    r = r.copy()
    r[conv] = 3
    return r


def _mutate(r, positions, rng):
    r = r.copy()
    for p in positions:
        r[p] = (r[p] + int(rng.integers(1, 4))) % 4
    return r


def genome():
    rng = np.random.default_rng(SEED)
    c = [rng.integers(0, 4, n).astype(np.uint8) for n in CHR_LENS]
    for n, copies in (UNIT_A, UNIT_B):
        unit = rng.integers(0, 4, n).astype(np.uint8)
        for ci, p in copies:
            c[ci][p:p + n] = unit
    ci, p, n = N_RUN
    c[ci][p:p + n] = dna.BASE_N
    return Genome.from_records([SeqRecord(f"chr{i + 1}", "", s)
                                for i, s in enumerate(c)])


def _at(g, ci, p, n=L):
    s = int(g.starts[ci]) + p
    return g.seq[s:s + n].copy()


def workload():
    """(genome, single-end records, bisulfite records, (mate-1, mate-2)
    records, priority BED text, constraints CSV text), seeded, through
    the port's host modules."""
    g = genome()
    rng = np.random.default_rng(SEED + 1)
    se = simreads.sim_reads(g, simreads.SimParams(
        n_reads=500, read_len=L, seed=SEED + 2, error_mode="illumina",
        subs_rate=0.01))
    extra = []

    def add(name, codes, strand=0):
        extra.append(SeqRecord(name, "", dna.revcomp(codes) if strand
                               else codes.astype(np.uint8)))
    # multi reads inside the units; unique reads over copies' left edges
    for (n, copies), n_multi, tag in ((UNIT_A, 30, "mA"),
                                      (UNIT_B, 12, "mB")):
        ci, p = copies[0]
        for i in range(n_multi):
            o = int(rng.integers(0, n - L + 1))
            add(f"{tag}{i}", _at(g, ci, p + o), i % 2)
    for i in range(15):
        ci, p = UNIT_A[1][0]
        add(f"eA{i}", _at(g, ci, p - 60 + i), i % 2)
    for ci, p in UNIT_B[1]:
        for i in range(6):
            add(f"eB{ci}_{i}", _at(g, ci, p - 50 + 3 * i), 0)
    # -6: 3-4 mismatches in the 5' 12 bases and 2-3 more downstream
    for i in range(20):
        ci, p = i % 2, 5_000 + 1_500 * i
        k5 = 3 + i % 2
        r = _mutate(_at(g, ci, p), list(rng.choice(12, k5, replace=False))
                    + list(20 + rng.choice(80, 2 + (i % 3 == 0),
                                           replace=False)), rng)
        add(f"p6_{i}", r, (i // 2) % 2)
    # -x: mismatched flanks; the last read has no 10-base exact run to trim
    for i in range(20):
        ci, p = i % 2, 6_000 + 1_700 * i
        left = [0, 2, 4] if i % 3 != 1 else []
        right = [95, 97, 99] if i % 3 != 0 else []
        add(f"x{i}", _mutate(_at(g, ci, p), left + right, rng), (i // 3) % 2)
    add("x_untrimmable", _mutate(_at(g, 1, 61_000), [9, 19, 29, 39, 49],
                                 rng))
    # -5: duplicate stacks on both strands
    for ci, p, strand, n in DUP_STACKS:
        for i in range(n):
            add(f"dup{ci}_{p}_{strand}_{i}", _at(g, ci, p), strand)
    # SNP reads: 20x over a 3 kbp region of chr2 carrying 12 SNPs
    ci, p0, n0 = SNP_REGION
    region = _at(g, ci, p0, n0)
    alt = region.copy()
    for o in SNP_OFFSETS:
        alt[o] = (alt[o] + 1 + o % 3) % 4
    for i in range(600):
        o = int(rng.integers(0, n0 - L + 1))
        src = region if (i % 2 and any(o <= h < o + L for h in HET)) \
            else alt
        r = src[o:o + L].copy()
        err = rng.random(L) < 0.005
        r[err] = (r[err] + 1) % 4
        add(f"snp{i}|{p0 + o}", r, i % 2)
    se = se + extra
    se = [se[i] for i in rng.permutation(len(se))]
    bis = []
    for i in range(96):
        ci = i % 2
        p = int(rng.integers(0, CHR_LENS[ci] - L))
        s = int(rng.integers(0, 2))
        bis.append(SeqRecord(f"bs{i}|{ci}|{p}|{s}", "",
                             bis_convert(_at(g, ci, p), s, rng)))
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=200, read_len=L, pe=True, pe_insert_min=200,
        pe_insert_max=500, error_mode="illumina", subs_rate=0.01,
        seed=SEED + 3))
    p_dup = DUP_STACKS[0][1]
    bed = (f"track name=prio\nchr1\t{p_dup - 200}\t{p_dup}\tends_at_dup\n"
           f"chr1\t{DUP_STACKS[1][1] + 99}\t{DUP_STACKS[1][1] + 100}\tlast\n"
           f"chr2\t{SNP_REGION[1]}\t{SNP_REGION[1] + 1500}\tsnps\n"
           f"chr1\t0\t20000\thead\n")
    cons = (f"# chrom,loci,allowed\nchr1,{DUP_STACKS[0][1] + 10},"
            f"\"{dna.decode(_at(g, 0, DUP_STACKS[0][1] + 10, 1))}\"\n"
            f"chr1,{DUP_STACKS[1][1] + 20},\"N\"\n"
            f"chr2,{SNP_REGION[1] + SNP_OFFSETS[0]},"
            f"{dna.decode(_at(g, 1, SNP_REGION[1] + SNP_OFFSETS[0], 1))}\n"
            "chrX,5,A\n")
    return g, se, bis, (r1, r2), bed, cons


def inputs_sha256(g, se, bis, pairs, bed, cons) -> str:
    h = hashlib.sha256(g.seq.tobytes())
    for rec in list(se) + list(bis) + list(pairs[0]) + list(pairs[1]):
        h.update(rec.name.encode())
        h.update(rec.codes.tobytes())
    h.update(bed.encode())
    h.update(cons.encode())
    return h.hexdigest()


def _sha(b: bytes) -> np.ndarray:
    return np.array(hashlib.sha256(b).hexdigest())


def sam_fields(lines) -> dict:
    """The records' flag, 1-based position and MAPQ, and the SHA-256 of
    the record lines."""
    recs = [ln.split(b"\t", 5) for ln in lines if not ln.startswith(b"@")]
    return {"flag": np.array([int(r[1]) for r in recs], np.int64),
            "pos": np.array([int(r[3]) for r in recs], np.int64),
            "mapq": np.array([int(r[4]) for r in recs], np.int64),
            "records": _sha(b"\n".join(ln for ln in lines
                                       if not ln.startswith(b"@")))}


def bam_records(payload: bytes) -> list[tuple[int, int]]:
    """(start, end) offsets of each record in a BAM's decompressed
    payload."""
    off = 4
    (l_text,) = struct.unpack_from("<i", payload, off)
    off += 4 + l_text
    (n_ref,) = struct.unpack_from("<i", payload, off)
    off += 4
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", payload, off)
        off += 8 + l_name
    out = []
    while off < len(payload):
        (block,) = struct.unpack_from("<i", payload, off)
        out.append((off, off + 4 + block))
        off += 4 + block
    return out


def bgzf_blocks(raw: bytes) -> list[tuple[int, int]]:
    """(compressed offset, uncompressed start) of each BGZF block."""
    out, coff, u = [], 0, 0
    while coff < len(raw):
        (bsize,) = struct.unpack_from("<H", raw, coff + 16)
        (isize,) = struct.unpack_from("<I", raw, coff + bsize + 1 - 4)
        out.append((coff, u))
        coff += bsize + 1
        u += isize
    return out


def ordinal_map(bam: Path) -> dict:
    """Virtual offset -> record ordinal of a BAM: each record's start, and
    the end of the last one as the count of records."""
    raw = bam.read_bytes()
    blocks = bgzf_blocks(raw)
    ustarts = [u for _, u in blocks]

    def voff(u):
        i = int(np.searchsorted(ustarts, u, side="right")) - 1
        # an offset at a block's end is also written as the next block's
        # start; both name the same place
        return [(blocks[j][0] << 16) | (u - blocks[j][1])
                for j in (i - 1, i) if j >= 0 and u - blocks[j][1] <= 65536]
    recs = bam_records(read_bgzf(bam))
    m = {}
    for k, (s, _) in enumerate(recs):
        for v in voff(s):
            m[v] = k
    for v in voff(recs[-1][1]):
        m[v] = len(recs)
    return m


def decode_bai(data: bytes, ordinal: dict) -> np.ndarray:
    """A BAI as rows (ref, bin, first record, past-the-last record), then
    (ref, -1, window, record) rows of its linear index."""
    assert data[:4] == b"BAI\x01"
    (n_ref,) = struct.unpack_from("<i", data, 4)
    off, rows = 8, []
    for ref in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        for _ in range(n_bin):
            b, n_chunk = struct.unpack_from("<Ii", data, off)
            off += 8
            for _ in range(n_chunk):
                c0, c1 = struct.unpack_from("<QQ", data, off)
                off += 16
                rows.append((ref, b, ordinal[c0], ordinal[c1]))
        (n_intv,) = struct.unpack_from("<i", data, off)
        off += 4
        for w in range(n_intv):
            (v,) = struct.unpack_from("<Q", data, off)
            off += 8
            rows.append((ref, -1, w, ordinal[v]))
    return np.array(rows, np.int64).reshape(-1, 4)


def decode_csi(csi: dict, ordinal: dict) -> np.ndarray:
    """A read_csi() dict as rows (ref, bin, loffset's record, first
    record, past-the-last record)."""
    rows = []
    for ref, bins in enumerate(csi["refs"]):
        for b, e in sorted(bins.items()):
            for c0, c1 in e["chunks"]:
                rows.append((ref, b, ordinal[e["loffset"]], ordinal[c0],
                             ordinal[c1]))
    return np.array([(csi["min_shift"], csi["depth"], -1, -1, -1)] + rows,
                    np.int64).reshape(-1, 5)


@contextlib.contextmanager
def _argv(group):
    """sys.argv, which the @PG line records, fixed for the run."""
    saved = sys.argv
    sys.argv = CMDLINE + [group]
    try:
        yield
    finally:
        sys.argv = saved


def summarize(group: str, d: Path) -> dict:
    """The golden's entries for one run's output directory."""
    from ..io.bam import read_csi
    out = {}
    for f in sorted(d.iterdir()):
        if f.name in ("reads.fa", "r2.fa", "genome.fa", "prio.bed",
                      "cons.csv", "bis.fa") or ".kix" in f.name \
                or ".kbx" in f.name:
            continue
        key = f"{group}:{f.name}"
        data = f.read_bytes()
        if f.suffix == ".npz":          # zip timestamps: compare arrays
            with np.load(f, allow_pickle=True) as z:
                for k in z.files:
                    v = z[k]
                    out[f"{key}:{k}"] = v.astype(str) if v.dtype == object \
                        else v
            continue
        if f.suffix == ".sam":
            for k, v in sam_fields(data.splitlines()).items():
                out[f"{key}:{k}"] = v
        if f.suffix == ".bam":
            payload = read_bgzf(f)
            out[f"{key}:payload"] = _sha(payload)
            out[f"{key}:raw"] = _sha(data)
            if (d / "out.bam.bai").exists() or (d / "out.bam.csi").exists():
                ordinal = ordinal_map(f)
                if (d / "out.bam.bai").exists():
                    out[f"{key}.bai:decoded"] = decode_bai(
                        (d / "out.bam.bai").read_bytes(), ordinal)
                if (d / "out.bam.csi").exists():
                    out[f"{key}.csi:decoded"] = decode_csi(
                        read_csi(d / "out.bam.csi"), ordinal)
            continue
        if f.suffix in (".bai", ".csi"):
            out[f"{key}:raw"] = _sha(data)
            continue
        out[f"{key}"] = _sha(data)
        out[f"{key}:lines"] = np.array(data.count(b"\n"))
        if f.name == "stats.csv":
            out[f"{key}:text"] = np.array(data.decode())
    return out


def compute(main, extra, g, se, bis, pairs, bed, cons) -> dict:
    """The golden's arrays through one package's CLI `main` (its argv list
    -> exit code), `extra` appended to each kalign/genpba argv (the port's
    --device)."""
    out = {"zlib_version": np.array(zlib.ZLIB_RUNTIME_VERSION)}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        fa = tmp / "genome.fa"
        write_fasta(fa, [SeqRecord(g.names[i], "", g.chrom_codes(i))
                         for i in range(g.nchroms())])
        kix, kbx = tmp / "genome.kix", tmp / "genome.kbx"
        for argv in (["index", "-i", str(fa), "-o", str(kix)],
                     ["index", "-m", "1", "-i", str(fa), "-o", str(kbx)]):
            if main(argv) != 0:
                raise RuntimeError(f"{argv[:3]} failed")
        kbx_file = kbx if kbx.exists() else Path(str(kbx) + ".npz")
        with np.load(kbx_file, allow_pickle=True) as z:
            for k in ("lut_k", "sa_ct", "lut_ct", "sa_ga", "lut_ga"):
                out[f"kbx:{k}"] = _sha(z[k].tobytes())
        runs = dict(GROUPS, genpba=GENPBA, bisulfite=BISULFITE)
        for group, flags in runs.items():
            d = tmp / group
            d.mkdir()
            reads = d / ("bis.fa" if group == "bisulfite" else "reads.fa")
            write_fasta(reads, bis if group == "bisulfite" else
                        (pairs[0] if group == "pe" else se))
            if group == "pe":
                write_fasta(d / "r2.fa", pairs[1])
            (d / "prio.bed").write_text(bed)
            (d / "cons.csv").write_text(cons)
            cmd = "genpba" if group == "genpba" else "kalign"
            outname = "out.pba.npz" if group == "genpba" else "out.sam"
            argv = [cmd, "-i", str(reads), "-I",
                    str(kbx_file if group == "bisulfite" else kix),
                    "-o", str(d / outname), "-b", str(BATCH)]
            argv += [f.replace("{d}", str(d)) for f in flags]
            with _argv(group):
                rc = main(argv + extra)
            if rc != 0:
                raise RuntimeError(f"kalign group {group} exited {rc}")
            out.update(summarize(group, d))
    return out


def port_main():
    from ..cli import main
    return main


def check_reach(out) -> list[str]:
    """What the workload must exercise, as messages for what it misses."""
    bad = []

    def stat(group, key):
        text = str(out[f"{group}:stats.csv:text"])
        for line in text.splitlines():
            if line.startswith(f'"classification","{key}",'):
                return int(line.rsplit(",", 1)[1])
        return 0
    if not stat("x", "trim"):
        bad.append("-x demotes no read to trim")
    if not (out["x:out.sam:mapq"] < 254).any():
        bad.append("-x trims no read")
    if not stat("cons", "constrained"):
        bad.append("no loci constraint violation")
    for g in ("Z", "B", "p5"):
        if not stat(g, "nohit") > stat("ml4", "nohit"):
            bad.append(f"the {g} filter demotes nothing")
    if not (out["ml5:out.sam:flag"] & 0x100).any():
        bad.append("--mlmode 5 reports no secondary")
    if not stat("ml3", "multi") < stat("p5", "multi"):
        bad.append("--mlmode 3 places no multi read")
    for k in ("snp:dsnp.disnp.csv", "snp:dsnp.trisnp.csv", "snp:m.fa",
              "snp:snps.csv", "ml2:na.fa", "ml3:ml.fa", "pe:cov.wig"):
        if out.get(f"{k}:lines", 0) < 2:
            bad.append(f"{k} holds no record")
    for k in ("snp:c.csv", "snp:cov.wig", "bai:out.bam.bai:raw",
              "csi:out.bam.csi:raw", "all:out.bam.bai:raw",
              "genpba:out.sam:records", "bisulfite:out.sam:records"):
        if k not in out:
            bad.append(f"no {k}")
    return bad
