"""Paired-end kalign on the card: the committed JAX golden
(kit4b_tpu_torch/data/kalign_pe_golden.npz) through the port on CUDA, the
pass against the CPU with inserts past the 16-bit wire field's sign bit,
and a pass that never waits for the device. This file imports no jax, so
on a machine with a card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_kalign_pe_card.py

The `cuda` tests skip where there is no card; the CPU test holds the port's
tier-1 rows to the golden here."""
import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import kalign as pk
from kit4b_tpu_torch.ops import pe_packed
from kit4b_tpu_torch.sim import simreads
from kit4b_tpu_torch.tools import make_kalign_pe_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def workload(golden):
    g, idx, reads = mg.workload()
    assert mg.inputs_sha256(g, reads) == str(golden["inputs_sha256"])
    return g, idx, reads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rows(device, idx, a1, a2, **kw):
    fns = mg.port_fns(device)
    return fns.tier1_rows(fns.aligner(idx), a1, a2, **kw)


def test_pass_on_cpu_matches_golden_rows(golden, workload):
    _, idx, reads = workload
    a1, a2 = (np.stack([r.codes for r in recs]) for recs in reads[150])
    got = _rows("cpu", idx, a1, a2, tier2=(mg.BATCH, 192, 96),
                min_ins=mg.MIN_INS, max_ins=mg.MAX_INS)
    np.testing.assert_array_equal(got, golden["rows_150"])


@pytest.mark.cuda
def test_golden_on_card(cuda, golden, workload):
    out = mg.compute(mg.port_fns(cuda), *workload)
    assert sorted(out) == sorted(k for k in golden if k != "inputs_sha256")
    for key, got in out.items():
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


@pytest.mark.cuda
@pytest.mark.parametrize("max_ins", [65535, 65536])
def test_long_inserts_on_card_match_cpu(cuda, workload, max_ins):
    g, idx, _ = workload
    r1, r2 = simreads.sim_reads(g, simreads.SimParams(
        n_reads=mg.BATCH, read_len=100, pe=True, pe_insert_min=33_000,
        pe_insert_max=60_000, seed=3, error_mode="illumina",
        subs_rate=0.01))
    a1, a2 = (np.stack([r.codes for r in recs]) for recs in (r1, r2))
    kw = dict(tier2=(mg.BATCH, 192, 96), min_ins=200, max_ins=max_ins)
    got = _rows(cuda, idx, a1, a2, **kw)
    np.testing.assert_array_equal(got, _rows("cpu", idx, a1, a2, **kw))
    acc = got[:, 5] == pe_packed.PAIR_ACCEPT
    assert acc.sum() > 0.5 * len(got) and got[acc, 4].min() > 32767


@pytest.mark.cuda
def test_pass_never_waits_for_the_card(cuda, workload):
    """Once its constants are on the card, a pass and its pinned uploads
    issue nothing that synchronises with the device."""
    from kit4b_tpu_torch.align import pe
    g, idx, reads = workload
    al = pk.KAligner(idx, batch_size=mg.BATCH, device=cuda)
    pal = pe.PeAligner(al, pair_min_len=mg.MIN_INS,
                       pair_max_len=mg.MAX_INS, pe_mode=1)
    list(pal.align_pairs(*reads[100]))          # warms the constants up
    a1, a2 = (np.stack([r.codes for r in recs])[:mg.BATCH]
              for recs in reads[100])
    ctx = pal._pctx
    kw = dict(genome_len=len(g.seq), offsets=ctx["offsets"],
              lut_k=idx.lut_k, read_len=100, n_compact=al.n_compact,
              n_extend=al.n_extend, max_ml=al.max_ml,
              max_tot=ctx["max_tot"], mm_delta=al.mm_delta,
              min_ins=mg.MIN_INS, max_ins=mg.MAX_INS,
              tier2=(mg.BATCH, 192, 96), tier3=None)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        up = [pe._upload(x, cuda) for a in (a1, a2)
              for x in pk.pack_reads_2bit(a)]
        rows = pe_packed.pe_pass_packed(ctx["gview"], ctx["sa"],
                                        ctx["lut2"], ctx["starts_d"], *up,
                                        **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert rows.shape == (mg.BATCH, 6)
