"""kalign's options and bisulfite alignment on the card: the committed JAX
golden (kit4b_tpu_torch/data/kalign_opts_golden.npz) through the port's
CLI on CUDA (every flag group: the phases, the filters, BAM/BAI/CSI, the
SNP side outputs, genpba, the paired-end route and kalign --bisulfite),
and one `bs_pass_compact` on the card against the CPU. This file imports
no jax, so on a machine with a card it runs without the JAX test
configuration:

    python -m pytest --noconftest tests/test_torch_kalign_opts_card.py -m cuda

The raw BGZF bytes are compared only where the card's machine runs the
zlib that wrote the golden; the decompressed payload and the decoded
indexes always."""
import zlib

import numpy as np
import pytest
import torch

from kit4b_tpu_torch import native
from kit4b_tpu_torch.align import bisulfite as pb
from kit4b_tpu_torch.align.kalign import build_pass_schedule
from kit4b_tpu_torch.ops import seed_extend_fast as F
from kit4b_tpu_torch.tools import make_kalign_opts_golden as mg
from test_torch_kmarkers_card import few_threads  # noqa: F401


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cli_on_card_matches_golden(golden, cuda):
    w = mg.workload()
    assert mg.inputs_sha256(*w) == str(golden["inputs_sha256"])
    out = mg.compute(mg.port_main(), ["--device", "cuda"], *w)
    same_zlib = str(golden["zlib_version"]) == zlib.ZLIB_RUNTIME_VERSION
    for key, got in out.items():
        if key == "zlib_version" or (key.endswith(":raw") and not same_zlib):
            continue
        np.testing.assert_array_equal(got, golden[key], err_msg=key)


@pytest.mark.cuda
def test_bs_pass_on_card_matches_cpu(golden, cuda):
    g, _, bis, _, _, _ = mg.workload()
    idx = pb.BsIndex.build(g)
    reads = np.stack([r.codes for r in bis])
    rows = {}
    for dev in (cuda, torch.device("cpu")):
        al = pb.BsAligner(idx, batch_size=len(reads), device=dev)
        (gct, sct, lct), (gga, sga, lga) = al._device(mg.L)
        r = torch.from_numpy(reads).to(dev)
        rc = F.revcomp_device(r)
        _, mtm = build_pass_schedule(mg.L, 5, 1, len(g.seq))
        rows[dev.type] = pb.bs_pass_compact(
            gct, sct, lct, gga, sga, lga, torch.where(r == 1, 3, r),
            torch.where(rc == 2, 0, rc), genome_len=len(g.seq),
            offsets=F.fast_offsets(mg.L, idx.lut_k, mtm), lut_k=idx.lut_k,
            n_compact=24, max_tot_mm=mtm, mm_delta=1).cpu().numpy()
    np.testing.assert_array_equal(rows["cuda"], rows["cpu"])
    assert (rows["cpu"][:, 0] >= 0).mean() > 0.8
