"""The port's PacBio tools (kit4b_tpu_torch/pacbio/: consensus, ecreads,
pbfilter, pbassemb) against the JAX package's on the inputs of
tests/test_pacbio.py, on the CPU: the same names, descriptions, bases and
stats, exactly; and that file's quality assertions, on the port's output
(errors halved by correction, the hairpin split at its fold, one contig
equal to the genome, the polished contig equal to it too).
"""
import numpy as np
import pytest
import torch

from kit4b_tpu.io.fasta import SeqRecord as JRec
from kit4b_tpu.pacbio import consensus as jcons
from kit4b_tpu.pacbio import ecreads as jec
from kit4b_tpu.pacbio import pbassemb as jasm
from kit4b_tpu.pacbio import pbfilter as jfilt
from kit4b_tpu_torch import native
from kit4b_tpu_torch.io.fasta import SeqRecord as PRec
from kit4b_tpu_torch.pacbio import consensus as pcons
from kit4b_tpu_torch.pacbio import ecreads as pec
from kit4b_tpu_torch.pacbio import pbassemb as pasm
from kit4b_tpu_torch.pacbio import pbfilter as pfilt
from kit4b_tpu_torch.pacbio.sswd import SWScores, banded_sw_batch
from torch_pacbio_cases import pacbio_test_inputs


@pytest.fixture(scope="module")
def inputs():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield pacbio_test_inputs()
    torch.set_num_threads(n)


def _recs(cls, pairs):
    return [cls(name, "", codes) for name, codes in pairs]


def _rows(records):
    return [(r.name, r.descr, np.asarray(r.codes, np.uint8).tobytes())
            for r in records]


def test_correct_reads_matches_jax_and_reduces_errors(inputs):
    kw = dict(min_read_len=300, min_corrected_len=200, band=512, batch=8)
    want = jec.correct_reads(_recs(JRec, inputs["ecreads"]),
                             jec.ECParams(**kw))
    got = pec.correct_reads(_recs(PRec, inputs["ecreads"]),
                            pec.ECParams(**kw), device="cpu")
    assert _rows(got) == _rows(want)
    assert len(got) >= 20
    ref = inputs["ec_ref"]

    def err(seq):
        a = banded_sw_batch(seq[None, :], np.array([len(seq)]), ref[None, :],
                            np.array([len(ref)]), np.array([1100]),
                            band=4096, scores=SWScores(1, -1, -2, -1),
                            device="cpu")[0]
        return (sum(n for op, n in a.ops if op != "M")
                + a.mismatches) / max(a.p_end - a.p_start, 1)

    raw = np.mean([err(c) for _, c in inputs["ecreads"][:4]])
    cor = np.mean([err(np.asarray(r.codes)) for r in got[:4]])
    assert cor < raw / 2, (raw, cor)


def test_filter_reads_matches_jax_and_splits_hairpin(inputs):
    want, wstats = jfilt.filter_reads(_recs(JRec, inputs["pbfilter"]),
                                      jfilt.FilterParams(min_len=300,
                                                         batch=2))
    got, stats = pfilt.filter_reads(_recs(PRec, inputs["pbfilter"]),
                                    pfilt.FilterParams(min_len=300, batch=2),
                                    device="cpu")
    assert _rows(got) == _rows(want) and stats == wstats
    assert stats["hairpins"] == 1
    assert sorted(r.name for r in got) == ["hp/sub1", "hp/sub2", "ok"]
    subs = {r.name: r for r in got}
    assert abs(len(subs["hp/sub1"].codes) - 700) < 40


def test_assemble_and_polish_match_jax(inputs):
    ref = inputs["asm_ref"]
    want = jasm.assemble(_recs(JRec, inputs["pbassemb"]), jasm.AssembParams(
        min_overlap=400, band=256,
        seed=jec.ECParams(min_read_len=0, band=256, min_seed_cores=8)))
    got = pasm.assemble(_recs(PRec, inputs["pbassemb"]), pasm.AssembParams(
        min_overlap=400, band=256,
        seed=pec.ECParams(min_read_len=0, band=256, min_seed_cores=8)),
        device="cpu")
    assert _rows(got) == _rows(want)
    assert len(got) == 1 and np.array_equal(np.asarray(got[0].codes), ref)

    kw = dict(min_read_len=0, min_corrected_len=0, band=256,
              min_seed_cores=8, batch=8)
    want = jasm.polish_contigs([JRec("ctg", "", inputs["dirty"])],
                               _recs(JRec, inputs["pbassemb"]),
                               jec.ECParams(**kw))
    got = pasm.polish_contigs([PRec("ctg", "", inputs["dirty"])],
                              _recs(PRec, inputs["pbassemb"]),
                              pec.ECParams(**kw), device="cpu")
    assert _rows(got) == _rows(want)
    assert np.array_equal(np.asarray(got[0].codes), ref)


@pytest.mark.parametrize("min_coverage", [1, 2, 3])
def test_consensus_builder_matches_jax(inputs, min_coverage):
    """One probe of the ecreads input and its SW overlaps (the port's
    engine on the CPU) deposited into both packages' ConsensusBuilder."""
    reads = [c for _, c in inputs["ecreads"]]
    probe = reads[0]
    L = max(len(r) for r in reads)
    n = len(reads) - 1
    probes = np.full((n, L), 0x0F, np.uint8)
    targets = np.full((n, L), 0x0F, np.uint8)
    for b, r in enumerate(reads[1:]):
        probes[b, :len(probe)] = probe
        targets[b, :len(r)] = r
    alns = banded_sw_batch(
        probes, np.full(n, len(probe)), targets,
        np.array([len(r) for r in reads[1:]]), np.zeros(n, np.int32),
        band=1024, scores=SWScores(1, -2, -2, -1), device="cpu")
    jb, pb = jcons.ConsensusBuilder(probe), pcons.ConsensusBuilder(probe)
    used = 0
    for a, t in zip(alns, reads[1:]):
        if a.score >= 50 and a.p_end - a.p_start >= 50:
            jb.add(a, t)
            pb.add(a, t)
            used += 1
    assert used >= 3
    for k in ("base_votes", "del_votes", "cov", "ins_cov"):
        np.testing.assert_array_equal(getattr(pb, k), getattr(jb, k))
    assert {i: dict(v) for i, v in pb.ins.items()} == \
        {i: dict(v) for i, v in jb.ins.items()}
    np.testing.assert_array_equal(pb.call(min_coverage),
                                  jb.call(min_coverage))
