"""The port's banded Smith-Waterman engine (kit4b_tpu_torch/pacbio/sswd.py
and the plain versions of kernels/sw.py) against the JAX package's
(kit4b_tpu/pacbio/sswd.py) on the CPU, exactly: on every edge case of
`make_pacbio_golden.sw_cases()`, the scan's best cell and its whole
[Lp, B, W] pointer array, the traceback's six arrays (ops zero-filled past
n) and every field of every SWAlignment `banded_sw_batch` returns.
Independent checks beside the JAX package: the score equals `sw_oracle`'s
full-matrix score where the band holds the whole alignment, the walk equals
JAX's host `_traceback_one` lane by lane (where it is not cut at L_OPS),
and the ops rebuild the score and the aligned spans.
"""
import numpy as np
import pytest
import torch

from kit4b_tpu.pacbio import sswd as jsw
from kit4b_tpu_torch.device import DeviceUnavailable
from kit4b_tpu_torch.kernels import sw
from kit4b_tpu_torch.pacbio import sswd as psw
from kit4b_tpu_torch.tools import make_pacbio_golden as mg
from torch_pacbio_cases import jax_fns

CASES = {c["label"]: c for c in mg.sw_cases()}
TRACED = [k for k, c in CASES.items() if c["traceback"]]


@pytest.fixture(scope="module")
def engines():
    """{label: (JAX arrays, port arrays, port alignments)}, filled as the
    tests ask."""
    return {}


def _both(engines, label):
    if label not in engines:
        n = torch.get_num_threads()
        torch.set_num_threads(2)
        try:
            case = CASES[label]
            engines[label] = (mg.engine(jax_fns(), case),
                              mg.engine(mg.port_fns("cpu"), case),
                              _alignments(case))
        finally:
            torch.set_num_threads(n)
    return engines[label]


def _alignments(case):
    m, mm, go, ge = case["scores"]
    return psw.banded_sw_batch(
        case["probes"], case["plens"], case["targets"], case["tlens"],
        case["diag0"], band=case["band"], scores=psw.SWScores(m, mm, go, ge),
        traceback=case["traceback"], device="cpu")


@pytest.mark.parametrize("label", list(CASES))
def test_engine_matches_jax(engines, label):
    want, got, _ = _both(engines, label)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("label", [k for k, c in CASES.items()
                                   if c["oracle"]])
def test_score_matches_full_matrix_oracle(engines, label):
    case = CASES[label]
    sc = psw.SWScores(*case["scores"])
    for a, (p, t) in zip(_both(engines, label)[2], case["pairs"]):
        want = psw.sw_oracle(p, t, sc)
        assert want == jsw.sw_oracle(p, t, jsw.SWScores(*case["scores"]))
        assert a.score == want


@pytest.mark.parametrize("label", TRACED)
def test_walk_matches_host_traceback(engines, label):
    """Each lane's walk against JAX's host `_traceback_one`, which walks
    the same pointer bytes without the L_OPS limit: equal wherever the
    walk is shorter than L_OPS."""
    case = CASES[label]
    _, got, alns = _both(engines, label)
    probes, targets = mg.padded(case)
    W = case["band"]
    L_OPS = probes.shape[1] + W
    for b, a in enumerate(alns):
        if int(got["n"][b]) == L_OPS:
            continue
        want = jsw._traceback_one(
            got["ptrs"][:, b, :], int(got["best"][b]), int(got["bi"][b]),
            int(got["bk"][b]), int(case["diag0"][b]), W, probes[b],
            targets[b])
        assert vars(a) == vars(want), b


@pytest.mark.parametrize("label", TRACED)
def test_ops_rebuild_score_and_spans(engines, label):
    case = CASES[label]
    _, got, alns = _both(engines, label)
    m, mm, go, ge = case["scores"]
    L_OPS = mg.padded(case)[0].shape[1] + case["band"]
    for b, a in enumerate(alns):
        if a.score <= 0 or int(got["n"][b]) == L_OPS:
            continue
        p, t = case["probes"][b], case["targets"][b]
        s, i, c, nm, nmm = 0, a.p_start, a.t_start, 0, 0
        for op, n in a.ops:
            if op == "M":
                for _ in range(n):
                    hit = p[i] == t[c]
                    s += m if hit else mm
                    nm, nmm = nm + hit, nmm + (not hit)
                    i += 1
                    c += 1
            elif op == "D":
                s += go + (n - 1) * ge
                i += n
            else:
                s += go + (n - 1) * ge
                c += n
        assert (i, c, s, nm, nmm) == (a.p_end, a.t_end, a.score, a.matches,
                                      a.mismatches), b


def test_the_cases_reach_every_edge(engines):
    """The golden's reach checks, on the port's CPU run of the engine cases
    (the four functions' checks are held in test_torch_pacbio_golden.py)."""
    out = {}
    for label in ("band edges", "equal peaks", "plen 0 lanes",
                  "diag0 negative and past Lt", "L_OPS cut", "L_OPS padded",
                  "scores tie", "oracle"):
        for k, v in _both(engines, label)[1].items():
            out[f"sw:{label}:{k}"] = v
    out.update({"pbfilter:stats": np.array([2, 2, 4, 1]),
                "ecreads": np.frombuffer(b"\n" * 8, np.uint8),
                "pbassemb": np.frombuffer(b"c\tlen=1200\t\n", np.uint8)})
    assert mg.check_reach(out) == []


def test_wrappers_on_cpu_tensors_launch_nothing():
    case = CASES["oracle"]
    sw.sw_scan.launches = sw.sw_traceback.launches = 0
    _alignments(case)
    assert sw.sw_scan.launches == sw.sw_traceback.launches == 0


def test_traceback_false_returns_scores_only():
    case = CASES["traceback=False"]
    alns = _alignments(case)
    assert [a.ops for a in alns] == [[], []]
    assert alns[0].score > 0 and alns[1].score == 0


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    case = CASES["oracle"]
    with pytest.raises(DeviceUnavailable):
        psw.banded_sw_batch(case["probes"], case["plens"], case["targets"],
                            case["tlens"], case["diag0"], band=128)


def test_wrappers_refuse_other_devices():
    p = torch.zeros((1, 4), dtype=torch.uint8, device="meta")
    i = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sw.sw_scan(p, p, i, i, i, W=4, match=1, mismatch=-1, gap_open=-3,
                   gap_ext=-1)
    ptrs = torch.zeros((4, 1, 4), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        sw.sw_traceback(ptrs, p, p, i, i, i, i, W=4, L_OPS=8)
