"""The port's trace spans (`utils/runtime.py` `span`) under torch.profiler
on the CPU: each is a plain host operator (`cpu_op`), never a user
annotation (which the profiler would mirror onto the device's timeline),
they nest, and the hammings sweep, kalign's single-end SAM route, the
suffix index build and the restricted probes emit theirs with outputs equal
to a run with no profiler."""
import logging

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from kit4b_tpu_torch import dna, native
from kit4b_tpu_torch.align import kalign
from kit4b_tpu_torch.index.sfx_index import SfxIndex
from kit4b_tpu_torch.io.fasta import Genome, SeqRecord, write_fasta
from kit4b_tpu_torch.kmer import hammings, hammings_mxu
from kit4b_tpu_torch.utils import runtime


def _profiled(fn, all_threads=False):
    """(fn's result, [(name, start_ns, end_ns, activity type, user
    annotation, thread)] of the host records, sorted by start)."""
    kw = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], **kw) as prof:
        out = fn()
    evs = sorted(((e.name(), e.start_ns(), e.end_ns(), e.activity_type(),
                   e.is_user_annotation(), e.start_thread_id())
                  for e in prof.profiler.kineto_results.events()),
                 key=lambda e: e[1])
    return out, evs


def _named(evs, prefix):
    return [e for e in evs if e[0].startswith(prefix)]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_a_host_operator_and_nests():
    def run():
        with record_function("t.annotation"):
            with runtime.span("t.outer"):
                with runtime.span("t.inner"):
                    return torch.ones(4) + 1
    out, evs = _profiled(run)
    assert torch.equal(out, torch.full((4,), 2.0))
    (ann,) = _named(evs, "t.annotation")
    (outer,), (inner,) = _named(evs, "t.outer"), _named(evs, "t.inner")
    assert ann[3:5] == ("user_annotation", True)
    for e in (outer, inner):
        assert e[3:5] == ("cpu_op", False)
    assert _inside(inner, outer) and _inside(outer, ann)
    assert any(e[0] == "aten::add" and _inside(e, inner) for e in evs)


def test_span_without_a_profiler_and_without_the_primitive(monkeypatch):
    """With no profiler running a span is an ordinary context manager; on
    a torch without `_RecordFunctionFast` it is a null context, never a
    `record_function`."""
    with runtime.span("t.unprofiled"):
        pass
    with pytest.raises(KeyError):
        with runtime.span("t.raises"):
            raise KeyError("x")
    monkeypatch.setattr(runtime, "_RecordFunctionFast", None)

    def run():
        with runtime.span("t.none"):
            return torch.zeros(1)
    _, evs = _profiled(run)
    assert not _named(evs, "t.none")
    assert _named(evs, "aten::zeros")


def test_phase_timer_phase_is_a_span(caplog):
    """PhaseTimer's log lines stay word for word (chip_smoke.py's
    `_PhaseLog` parses them) and each phase is a span of its name."""
    t = runtime.PhaseTimer()

    def run():
        with t.phase("load genome"):
            with t.phase("sweep"):
                torch.zeros(2)
    with caplog.at_level(logging.INFO, logger="kit4b_tpu_torch"):
        _, evs = _profiled(run)
    (load,), (sweep,) = _named(evs, "load genome"), _named(evs, "sweep")
    assert load[3] == sweep[3] == "cpu_op" and _inside(sweep, load)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[0] == "phase load genome: start"
    assert msgs[1] == "phase sweep: start"
    assert msgs[2].startswith("phase sweep: ") and msgs[2].endswith("s")
    assert msgs[3].startswith("phase load genome: ")
    assert list(t.phases) == ["sweep", "load genome"]


def _genome(n, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, n).astype(np.uint8)
    g[n // 3] = dna.BASE_EOS
    g[n - 60:n - 30] = g[20:50]
    return g


ROW_BLOCK = ["hammings.rows", "hammings.onehot", "hammings.collect",
             "hammings.fold"]


@pytest.mark.parametrize("antisense", [True, False])
def test_hammings_sweep_spans(monkeypatch, antisense):
    """One `hammings.sweep` around one `upload`, one `partners` (the node's
    partner one-hot of both strands), then a `rows` a row block holding its
    `onehot`, then its `collect`, which holds the `fold`."""
    g = _genome(3000, 5)
    monkeypatch.setattr(hammings_mxu, "BLOCK_ROWS", 512)
    kw = dict(antisense=antisense, node=1, numnodes=2, T=256, S=128,
              device="cpu")
    want = hammings_mxu.hammings_exhaustive_mxu(g, 13, **kw)
    got, evs = _profiled(
        lambda: hammings_mxu.hammings_exhaustive_mxu(g, 13, **kw))
    np.testing.assert_array_equal(got, want)
    spans = _named(evs, "hammings.")
    (sweep,) = _named(spans, "hammings.sweep")
    chunks = -(-3072 // 512)
    names = ["hammings.upload", "hammings.partners"] + ROW_BLOCK * chunks
    inner = [e for e in spans if e is not sweep]
    assert [e[0] for e in inner] == names
    assert all(e[3] == "cpu_op" and _inside(e, sweep) for e in spans)
    blocks = _named(inner, "hammings.rows")
    outer = [e for e in inner if e[0] not in ("hammings.rows",
                                               "hammings.fold")]
    assert all(a[2] <= b[1] for a, b in zip(outer, outer[1:]))
    assert all(a[2] <= b[1] for a, b in zip(blocks, blocks[1:]))
    for i, blk in enumerate(blocks):
        onehot, collect, fold = inner[3 + 4 * i:6 + 4 * i]
        assert all(_inside(e, blk) for e in (onehot, collect, fold))
        assert _inside(fold, collect)


def test_hammings_exhaustive_has_one_sweep():
    """The benchmark's entry, `hammings_exhaustive`, on the default chunk:
    one sweep, one row block."""
    g = _genome(2000, 6)
    want = hammings.hammings_exhaustive(g, 11, device="cpu")
    got, evs = _profiled(
        lambda: hammings.hammings_exhaustive(g, 11, device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert [e[0] for e in _named(evs, "hammings.")] == [
        "hammings.sweep", "hammings.upload", "hammings.partners"] + ROW_BLOCK


@pytest.fixture(scope="module")
def lib():
    try:
        return native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")


@pytest.fixture(scope="module")
def index(lib):
    rng = np.random.default_rng(31)
    a = rng.integers(0, 4, 20_000).astype(np.uint8)
    b = rng.integers(0, 4, 9_000).astype(np.uint8)
    b[1000:1400] = a[5000:5400]
    a[7000:7040] = dna.BASE_N
    return SfxIndex.build(Genome.from_records(
        [SeqRecord("a", "", a), SeqRecord("b", "", b)]))


def test_sfx_index_build_spans_in_order(index):
    want = index
    got, evs = _profiled(lambda: SfxIndex.build(want.genome))
    assert got.lut_k == want.lut_k
    np.testing.assert_array_equal(got.sa_clean, want.sa_clean)
    np.testing.assert_array_equal(got.lut, want.lut)
    spans = _named(evs, "sfx.")
    assert [e[0] for e in spans] == ["sfx.sais", "sfx.mask", "sfx.keys",
                                     "sfx.lut"]
    assert all(e[3] == "cpu_op" for e in spans)
    assert all(a[2] <= b[1] for a, b in zip(spans, spans[1:]))


def test_hammings_restricted_spans(index):
    """A submit a batch, a drain a batch, a fold inside each drain."""
    kw = dict(max_hamming=2, batch=4096, device="cpu")
    want = hammings.hammings_restricted(index, 25, **kw)
    got, evs = _profiled(
        lambda: hammings.hammings_restricted(index, 25, **kw))
    np.testing.assert_array_equal(got, want)
    subs = _named(evs, "restricted.submit")
    drains = _named(evs, "restricted.drain")
    folds = _named(evs, "restricted.fold")
    assert len(subs) == len(drains) == len(folds) > 1
    assert all(_inside(f, d) for f, d in zip(folds, drains))


def test_write_sam_fast_spans(tmp_path, index):
    """The block route: `kalign.parse` on the producer thread, the rest on
    the consumer's; every batch uploads, waits for its rows, climbs (or
    skips) the ladder and is prepared, formatted and written."""
    g = index.genome
    rng = np.random.default_rng(4)
    recs = []
    for i in range(700):
        p = int(rng.integers(0, len(g.seq) - 200))
        codes = g.seq[p:p + 100].copy()
        if (codes >= 4).any():
            codes = rng.integers(0, 4, 100).astype(np.uint8)
        if i % 2:
            codes = dna.revcomp(codes)
        recs.append(SeqRecord(f"r{i}", "", codes))
    src = tmp_path / "reads.fa"
    write_fasta(src, recs)
    aligner = kalign.KAligner(index, batch_size=256, device="cpu")

    def run(tag):
        st = kalign.write_sam_fast(tmp_path / f"{tag}.sam", index, aligner,
                                   str(src), cmdline="c")
        return st, (tmp_path / f"{tag}.sam").read_bytes()
    want = run("plain")
    got, evs = _profiled(lambda: run("traced"), all_threads=True)
    assert got == want
    spans = _named(evs, "kalign.")
    main = {e[5] for e in _named(spans, "kalign.sam_write")}
    assert len(main) == 1
    batches = -(-700 // 256)
    parse = [e for e in spans if e[0] == "kalign.parse"]
    # a block each, and the call that finds the input's end
    assert len(parse) == batches + 1
    assert {e[5] for e in parse}.isdisjoint(main)
    for name in ("kalign.upload", "kalign.result_wait", "kalign.escalate",
                 "kalign.sam_prep", "kalign.sam_format", "kalign.sam_write"):
        got_n = [e for e in spans if e[0] == name]
        assert len(got_n) == batches, name
        assert {e[5] for e in got_n} == main
    waits = [e for e in spans if e[0] == "kalign.parse_wait"]
    assert len(waits) == batches + 1 and {e[5] for e in waits} == main
    assert all(e[3] == "cpu_op" and not e[4] for e in spans)
