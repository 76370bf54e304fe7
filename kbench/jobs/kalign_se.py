"""Job `kalign_se`: single-end alignment of a readset to SAM.

One unit is one pass of `align/kalign.py` `write_sam_fast` over the
readset's FASTA, with the aligner the CLI's `kalign -b <batch> -M 1`
builds: FASTA parse, 2-bit pack, the tier-1 pass on the device, the host
ladder, the native SAM formatter. The SAM goes into a pipe that a thread
drains, so no pass waits on a disk: the thread keeps the first pass's
text for the check and a digest of every pass. The aligner, its device
tables and the index are built once, in set-up, as a long-running aligner
would hold them.

The check, on a sample of reads drawn from the seed: each read's SAM
record (accepted or not, locus, strand, NM) against the plain reference;
the SAM holds one record a read, in input order; every pass wrote the
first pass's SAM text and class counts.
"""
from __future__ import annotations

import fcntl
import hashlib
import os
import threading

import numpy as np

from .. import recipes
from ..reference import kalign_se as ref

SPANS = [
    ("kit4b_tpu_torch.align.kalign", "KAligner._submit", "kalign.submit"),
    ("kit4b_tpu_torch.align.kalign", "KAligner._collect_compact",
     "kalign.collect"),
    ("kit4b_tpu_torch.align.kalign", "KAligner._escalate", "kalign.ladder"),
    ("kit4b_tpu_torch.align.kalign", "pack_reads_2bit", "kalign.pack"),
    ("kit4b_tpu_torch.align.kalign", "write_sam_fast", "kalign.pass"),
]
FLAG_UNMAPPED, FLAG_REVERSE = 4, 16
F_SETPIPE_SZ = 1031


class SamSink:
    """A pipe whose write end `path` names (/dev/fd/N, which the SAM writer
    opens and closes as a file), drained by a thread into a digest and,
    with `keep`, a list of the chunks read."""

    def __init__(self, keep: bool):
        self.r, self.w = os.pipe()
        try:
            fcntl.fcntl(self.w, F_SETPIPE_SZ, 1 << 20)
        except OSError:
            pass
        self.path = f"/dev/fd/{self.w}"
        self.keep, self.chunks, self.digest = keep, [], hashlib.sha1()
        self.thread = threading.Thread(target=self._drain, daemon=True)
        self.thread.start()

    def _drain(self) -> None:
        while chunk := os.read(self.r, 1 << 20):
            self.digest.update(chunk)
            if self.keep:
                self.chunks.append(chunk)

    def close(self) -> str:
        os.close(self.w)
        self.thread.join()
        os.close(self.r)
        return self.digest.hexdigest()


class Job:
    """A run's readset, index and aligner; `unit` is one pass."""

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 tmpdir: str):
        self.seed, self.device, self.tmp = seed, device, tmpdir
        self.rule = dict(config["aligner"])
        self.rule["batch_size"] = int(traffic["batch_size"])
        self.sample_n = int(traffic["check_reads"])
        names, chroms, _ = recipes.genome(seed, config["genome"])
        self.chrom_names = names
        self.seq = recipes.concat(chroms)
        self.starts = np.cumsum([0] + [len(c) + 1 for c in chroms[:-1]])
        self.names, self.reads, _ = recipes.illumina_se_reads(
            seed, names[0], chroms[0], traffic["reads"])
        self.fasta = os.path.join(tmpdir, "reads.fa")
        recipes.write_reads_fasta(self.fasta, self.names, self.reads)
        self.work_per_unit = len(self.reads)
        B = self.rule["batch_size"]
        self.info = {"batches_per_unit": -(-len(self.reads) // B)}
        self.sam = b""
        self.stats: list[dict] = []
        self.digests: list[str] = []
        self.aligner = None

    def prepare(self) -> None:
        """The program's set-up: the index, the aligner, and a warm-up
        that builds its device tables and runs one batch of the readset's
        shapes and each ladder tier once."""
        from kit4b_tpu_torch.align import kalign
        from kit4b_tpu_torch.index.sfx_index import SfxIndex
        from kit4b_tpu_torch.io.fasta import Genome
        lengths = np.diff(np.append(self.starts, len(self.seq))) - 1
        g = Genome(list(self.chrom_names), self.starts.astype(np.int64),
                   lengths.astype(np.int64), self.seq)
        self.index = SfxIndex.build(g)
        r = self.rule
        self.aligner = kalign.KAligner(
            self.index, max_subs=int(r["max_subs"]),
            mm_delta=int(r["mm_delta"]), max_ml=int(r["max_ml"]),
            max_ns=int(r["max_ns"]), batch_size=r["batch_size"],
            sens=r["sens"], device=self.device)
        B = r["batch_size"]
        warm = os.path.join(self.tmp, "warm.fa")
        recipes.write_reads_fasta(warm, self.names[:B], self.reads[:B])
        kalign.write_sam_fast(os.devnull, self.index, self.aligner, warm,
                              cmdline=self.cmdline, emit_unmapped=True)
        last = len(self.aligner.escalation) - 1
        for t, (bt, nct) in enumerate(self.aligner.escalation):
            out = self.aligner._submit(self.reads[:bt], n_compact=nct,
                                       compact=False, capped=t == last)
            for v in out.values():
                v.cpu()
        os.unlink(warm)

    @property
    def cmdline(self) -> str:
        return (f"kalign -i reads.fa -I genome.kix -o out.sam -b "
                f"{self.rule['batch_size']} -M 1")

    def unit(self, i: int) -> None:
        from kit4b_tpu_torch.align import kalign
        sink = SamSink(keep=i == 0)
        try:
            self.stats.append(kalign.write_sam_fast(
                sink.path, self.index, self.aligner, self.fasta,
                cmdline=self.cmdline, emit_unmapped=True))
        finally:
            self.digests.append(sink.close())
        if i == 0:
            self.sam = b"".join(sink.chunks)

    def free(self) -> None:
        self.aligner = self.index = None

    # --- the check ---------------------------------------------------------
    def sample(self) -> np.ndarray:
        rng = np.random.default_rng([self.seed, 11])
        n = len(self.reads)
        return np.sort(rng.choice(n, min(self.sample_n, n), replace=False))

    def answers(self, sample: np.ndarray) -> tuple[dict, int, int]:
        """The first pass's SAM records of the sampled reads, the number of
        records, and the sampled records whose QNAME is not the read's."""
        lines = [ln for ln in self.sam.split(b"\n")
                 if ln and not ln.startswith(b"@")]
        chrom_of = {n.encode(): s for n, s in zip(self.chrom_names,
                                                  self.starts)}
        got = {k: np.full(len(sample), -1, np.int64)
               for k in ("pos", "strand", "nm")}
        got["accepted"] = np.zeros(len(sample), bool)
        misnamed = 0
        for k, i in enumerate(sample):
            if i >= len(lines):
                misnamed += 1
                continue
            f = lines[i].split(b"\t")
            misnamed += f[0] != self.names[i].tobytes()
            flag = int(f[1])
            if flag & FLAG_UNMAPPED:
                continue
            nm = [x for x in f[11:] if x.startswith(b"NM:i:")]
            got["accepted"][k] = True
            got["pos"][k] = chrom_of[f[2]] + int(f[3]) - 1
            got["strand"][k] = 1 if flag & FLAG_REVERSE else 0
            got["nm"][k] = int(nm[0][5:]) if nm else -1
        return got, len(lines), misnamed

    def reference(self, sample: np.ndarray, control: bool = False) -> dict:
        """The reference's answers; the control lowers the mismatch limit
        by one (a sensitivity cut: reads at the limit go unaligned)."""
        reads = self.reads[sample]
        L = reads.shape[1]
        mm = ref.max_mismatches(L, int(self.rule["max_subs"]))
        return ref.align(self.seq, reads, self.rule, self.device,
                         max_mm=mm - 1 if control else mm)

    @staticmethod
    def compare(got: dict, want: dict) -> int:
        """Sampled reads whose answer differs from the reference's."""
        acc = want["accepted"]
        differ = got["accepted"] != acc
        for k in ("pos", "strand", "nm"):
            differ |= acc & (got[k] != want[k])
        return int(differ.sum())

    def check(self) -> dict:
        sample = self.sample()
        got, n_records, misnamed = self.answers(sample)
        want = self.reference(sample)
        return {
            "sam_records_missing": (abs(n_records - len(self.reads)), 0),
            "sampled_qnames_wrong": (misnamed, 0),
            "sampled_reads_differing": (self.compare(got, want), 0),
            "passes_with_other_sam": (
                sum(d != self.digests[0] for d in self.digests[1:])
                + sum(s != self.stats[0] for s in self.stats[1:]), 0),
        }

    def control(self) -> dict:
        sample = self.sample()
        return {"sampled_reads_differing": (self.compare(
            self.reference(sample, control=True), self.reference(sample)),
            0)}
