"""The port's BAM writer and readers (kit4b_tpu_torch/io/bam.py) against
the JAX package's, byte for byte on this machine's zlib: BGZF blocks, BAM
records of every field the kalign writers set, the BAI and CSI indexes
with their virtual offsets across many blocks, `write_sam`'s BAM branch
(unsorted, and coordinate-sorted with a BAI or a CSI) and
`write_sam_fast`'s hand-off to it; and the readers' round trips
(`read_bgzf`, `read_bam`, `read_csi`), each package reading the other's
files."""
import numpy as np
import pytest

from kit4b_tpu.align import kalign as jk
from kit4b_tpu.io import bam as jbam
from kit4b_tpu.io.fasta import Genome as JGenome
from kit4b_tpu.io.fasta import SeqRecord as JRec
from kit4b_tpu.io.sam import SamAlignment as JAln
from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io import bam as pbam
from kit4b_tpu_torch.io.sam import SamAlignment as PAln
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401

NAMES, LENGTHS = ["chr1", "chr2", "chrM"], [120_000, 80_000, 16_569]


def _alignments(n, seed):
    """SamAlignment field tuples: mapped on three chromosomes, both
    strands, plain, trimmed, spliced and indel CIGARs, NM and string tags,
    with and without qualities; unmapped records; mates (= and named)."""
    rng = np.random.default_rng(seed)
    cigars = ["100M", "5S90M5S", "40M200N60M", "30M2D70M", "50M3I47M", "*"]
    out = []
    for i in range(n):
        cig = cigars[int(rng.integers(0, len(cigars)))]
        unmapped = cig == "*"
        rname = "*" if unmapped else NAMES[int(rng.integers(0, 3))]
        seq = "".join("ACGTN"[b] for b in rng.integers(0, 5, 100))
        qual = "*" if rng.random() < 0.3 else "".join(
            chr(33 + q) for q in rng.integers(2, 41, 100))
        tags = () if unmapped else (f"NM:i:{int(rng.integers(0, 6))}",) + (
            ("RG:Z:grp1",) if rng.random() < 0.2 else ())
        mate = rng.random() < 0.2 and not unmapped
        out.append(dict(
            qname=f"r{i}", flag=4 if unmapped else int(rng.choice(
                [0, 16, 0x100, 0x110])),
            rname=rname, pos=0 if unmapped else int(rng.integers(1, 16_000)),
            mapq=0 if unmapped else int(rng.integers(1, 255)), cigar=cig,
            rnext="=" if mate else "*",
            pnext=int(rng.integers(1, 16_000)) if mate else 0,
            tlen=int(rng.integers(-500, 500)) if mate else 0,
            seq=seq, qual=qual, tags=tags))
    return out


def _sorted(recs):
    order = {n: i for i, n in enumerate(NAMES)}
    return sorted(recs, key=lambda r: (order.get(r["rname"], 1 << 30),
                                       r["pos"]))


def test_bgzf_blocks_and_offsets_match(tmp_path):
    rng = np.random.default_rng(1)
    chunks = [rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()
              for n in rng.integers(1, 50_000, 12)]
    writers = []
    for tag, mod in (("j", jbam), ("p", pbam)):
        w = mod.BgzfWriter(tmp_path / f"{tag}.gz")
        offs = []
        for c in chunks:
            w.write(c)
            offs.append(w.u_pos)
        w.close()
        writers.append((w.block_map, [w.virtual_offset(u) for u in offs]))
    assert writers[0] == writers[1] and len(writers[1][0]) > 5
    assert (tmp_path / "j.gz").read_bytes() == (tmp_path / "p.gz").read_bytes()
    for mod in (jbam, pbam):
        for tag in "jp":
            assert mod.read_bgzf(tmp_path / f"{tag}.gz") == b"".join(chunks)


@pytest.mark.parametrize("index", [False, True, "csi"])
def test_bam_writer_and_index_bytes_match(tmp_path, index):
    recs = _alignments(2500, 7)
    if index:
        recs = _sorted(recs)
    for tag, mod, aln in (("j", jbam, JAln), ("p", pbam, PAln)):
        with mod.BamWriter(tmp_path / f"{tag}.bam", NAMES, LENGTHS,
                           pg_cl="a b", index=index) as w:
            for r in recs:
                w.write(aln(**r))
    files = [p.name[1:] for p in tmp_path.iterdir() if p.name[0] == "p"]
    assert sorted(files) == sorted([".bam"] + (
        [".bam.csi" if index == "csi" else ".bam.bai"] if index else []))
    for f in files:
        assert (tmp_path / f"j{f}").read_bytes() == \
            (tmp_path / f"p{f}").read_bytes(), f
    # the payload spans many blocks, so the index's offsets do too
    assert len(pbam.read_bgzf(tmp_path / "p.bam")) > 8 * 60_000


def test_readers_round_trip_across_packages(tmp_path):
    recs = _sorted(_alignments(800, 11))
    for tag, mod, aln in (("j", jbam, JAln), ("p", pbam, PAln)):
        with mod.BamWriter(tmp_path / f"{tag}.bam", NAMES, LENGTHS,
                           index="csi") as w:
            for r in recs:
                w.write(aln(**r))
    for writer in "jp":
        back = {}
        for tag, mod in (("j", jbam), ("p", pbam)):
            back[tag] = [vars(a) for a in mod.read_bam(
                tmp_path / f"{writer}.bam")]
            assert mod.read_csi(tmp_path / f"{writer}.bam.csi") == \
                jbam.read_csi(tmp_path / f"{writer}.bam.csi")
        assert back["j"] == back["p"]
        want = [dict(r, rnext=("=" if r["rnext"] == "=" and r["rname"] != "*"
                               else "*"), tags=list(r["tags"]))
                for r in recs]
        got = [dict(a, tags=list(a["tags"])) for a in back["p"]]
        # unmapped records keep no position
        for w in want:
            if w["rname"] == "*":
                w["pos"] = 0
        assert got == want


@pytest.fixture(scope="module")
def stream():
    """A (rec, res) stream on the options golden's genome, as both
    packages' types: accepted reads on both strands and chromosomes with
    plain, trimmed and indel CIGARs, secondaries, and unaligned reads."""
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    g, se, _, _, _, _ = mg.workload()
    idx = SfxIndex.build(g)
    rng = np.random.default_rng(3)
    out = []
    cigars = [None, "4S92M4S", "30M2D70M", "10S90M"]
    for i, rec in enumerate(se[:900]):
        if i % 9 == 0:
            res = pk.AlignResult("nohit")
        else:
            res = pk.AlignResult(
                "accepted", strand=int(rng.integers(0, 2)),
                pos=int(rng.integers(0, 190_000)), mm=int(rng.integers(0, 4)),
                n_low=1, cigar=cigars[i % 4], secondary=i % 13 == 0)
        out.append((rec, res))
    jg = JGenome(list(g.names), g.starts, g.lengths, g.seq)
    jstream = []
    for rec, res in out:
        r = jk.AlignResult(res.nar, strand=res.strand, pos=res.pos,
                           mm=res.mm, n_low=res.n_low, cigar=res.cigar,
                           secondary=res.secondary)
        jstream.append((JRec(rec.name, rec.descr, rec.codes, rec.qual), r))
    from kit4b_tpu.index.sfx_index import SfxIndex as JSfx
    return (JSfx(jg, idx.lut_k, idx.sa_clean, idx.lut), jstream), \
        (idx, out)


@pytest.mark.parametrize("bam_index", [False, True, "csi"])
def test_write_sam_bam_branch_matches_jax(tmp_path, stream, bam_index):
    outs = []
    for tag, mod, (idx, recs) in zip("jp", (jk, pk), stream):
        st = mod.write_sam(tmp_path / f"{tag}.bam", idx, recs,
                           cmdline="c d", bam_index=bam_index,
                           stats_path=tmp_path / f"{tag}.csv")
        outs.append(dict(st))
    assert outs[0] == outs[1]
    names = sorted(p.name[1:] for p in tmp_path.iterdir()
                   if p.name[0] == "p")
    assert names == sorted([".bam", ".csv"] + (
        [".bam.csi" if bam_index == "csi" else ".bam.bai"]
        if bam_index else []))
    for f in names:
        assert (tmp_path / f"j{f}").read_bytes() == \
            (tmp_path / f"p{f}").read_bytes(), f
    recs = list(pbam.read_bam(tmp_path / "p.bam"))
    pos = [(r.rname, r.pos) for r in recs if r.rname != "*"]
    assert (pos == sorted(pos, key=lambda p: (["chr1", "chr2"].index(p[0]),
                                              p[1]))) == bool(bam_index)


def test_write_sam_fast_hands_bam_to_write_sam(tmp_path, stream):
    """A .bam path leaves the native formatter for the per-record writer
    (unsorted BAM, no index), in both packages."""
    (jidx, _), (idx, recs) = stream
    reads = [rec for rec, _ in recs[:300]]
    for tag, mod, index, kw in (("j", jk, jidx, {}),
                                ("p", pk, idx, {"device": "cpu"})):
        mod.write_sam_fast(tmp_path / f"{tag}.bam", index,
                           mod.KAligner(index, batch_size=128, **kw),
                           reads if tag == "p" else
                           [JRec(r.name, r.descr, r.codes, r.qual)
                            for r in reads], cmdline="e")
    assert (tmp_path / "j.bam").read_bytes() == \
        (tmp_path / "p.bam").read_bytes()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["j.bam", "p.bam"]
