"""The JAX package's side of the PacBio comparisons
(tests/test_torch_sswd.py, test_torch_pacbio.py, test_torch_pacbio_golden.py):
the callables of `make_pacbio_golden.compute()` through kit4b_tpu on the
CPU, JAX imported lazily. Pytest does not collect this file."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np


def jax_fns() -> SimpleNamespace:
    import jax.numpy as jnp

    from kit4b_tpu.io.fasta import SeqRecord
    from kit4b_tpu.pacbio import ecreads, pbassemb, pbfilter, sswd

    def scan(probes, targets, plens, tlens, diag0, *, W, match, mismatch,
             gap_open, gap_ext):
        out = sswd._sw_scan(
            jnp.asarray(probes), jnp.asarray(targets),
            jnp.asarray(plens, np.int32), jnp.asarray(tlens, np.int32),
            jnp.asarray(diag0, np.int32), W=W, Lp=probes.shape[1],
            traceback=True, match=match, mismatch=mismatch,
            gap_open=gap_open, gap_ext=gap_ext)
        return tuple(np.asarray(x) for x in out)

    def traceback(ptrs, probes, targets, best, bi, bk, diag0, *, W, L_OPS):
        out = sswd._traceback_dev(
            jnp.asarray(ptrs), jnp.asarray(probes), jnp.asarray(targets),
            jnp.asarray(best), jnp.asarray(bi), jnp.asarray(bk),
            jnp.asarray(diag0, np.int32), W=W, L_OPS=L_OPS)
        return tuple(np.asarray(x) for x in out)

    return SimpleNamespace(
        scan=scan, traceback=traceback, banded=sswd.banded_sw_batch,
        SWScores=sswd.SWScores, SeqRecord=SeqRecord,
        ECParams=ecreads.ECParams, FilterParams=pbfilter.FilterParams,
        AssembParams=pbassemb.AssembParams,
        correct_reads=ecreads.correct_reads,
        filter_reads=pbfilter.filter_reads, assemble=pbassemb.assemble,
        polish_contigs=pbassemb.polish_contigs)


def pacbio_test_inputs() -> dict:
    """The inputs of tests/test_pacbio.py's SW, ecreads, pbfilter and
    pbassemb tests as that file builds them when it runs in order (its
    module rng(11) feeds `_mutate` in the oracle test first, then in the
    ecreads test): code arrays and names."""
    mrng = np.random.default_rng(11)

    def _mutate(s, sub=0.05, ind=0.06):
        out = []
        for b in s:
            r = mrng.random()
            if r < ind / 2:
                continue
            if r < ind:
                out.extend([b, mrng.integers(0, 4)])
            elif r < ind + sub:
                out.append((b + 1 + mrng.integers(0, 3)) % 4)
            else:
                out.append(b)
        return np.array(out, np.uint8)

    rng = np.random.default_rng(3039)
    for _ in range(4):                         # test_banded_sw_matches_oracle
        core = rng.integers(0, 4, 70).astype(np.uint8)
        rng.integers(0, 4, 15), rng.integers(0, 4, 15)
        rng.integers(0, 4, 20)
        _mutate(core)
        rng.integers(0, 4, 20)
    rng = np.random.default_rng(2876)          # test_ecreads_reduces_errors
    ec_ref = rng.integers(0, 4, 3000).astype(np.uint8)
    ec = []
    for i in range(24):
        s = rng.integers(0, 2200)
        ec.append((f"r{i}", _mutate(ec_ref[s:s + 800], sub=0.02, ind=0.08)))
    rng = np.random.default_rng(3007)          # test_pbfilter_splits_hairpin
    arm = rng.integers(0, 4, 700).astype(np.uint8)
    rc = np.where(arm[::-1] < 4, 3 - arm[::-1], arm[::-1]).astype(np.uint8)
    filt = [("hp", np.concatenate([arm, rc])),
            ("ok", rng.integers(0, 4, 1200).astype(np.uint8))]
    rng = np.random.default_rng(2540)          # test_pbassemb_and_polish
    asm_ref = rng.integers(0, 4, 4000).astype(np.uint8)
    asm = [(f"c{i}", asm_ref[s:s + 1200].copy())
           for i, s in enumerate(range(0, 2801, 400))]
    dirty = asm_ref.copy()
    pos = rng.choice(len(asm_ref) - 100, 25, replace=False) + 50
    dirty[pos] = (dirty[pos] + 1) % 4
    return dict(ec_ref=ec_ref, ecreads=ec, pbfilter=filt, asm_ref=asm_ref,
                pbassemb=asm, dirty=dirty)
