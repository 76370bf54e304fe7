"""`parallel/swservice.py` and `parallel/distributed.py` of the port
against the JAX package's: `SWService.score` on `[cpu] * D` (D 1, 2, 4)
and `SWService.align` against JAX's on its virtual CPU mesh and the
committed golden, on `make_parallel_golden.sw_jobs()` (unequal lengths,
diagonals at the band's edges, InDels, a band past the target); both held
to `banded_sw_batch`; the distributed helpers as tests/test_parallel.py
drives JAX's; and two gloo processes, joined through a file under
tmp_path, whose shards merge to the one-process output."""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from kit4b_tpu.parallel import distributed as jdist
from kit4b_tpu_torch.pacbio.sswd import SWScores, banded_sw_batch
from kit4b_tpu_torch.parallel import distributed as dist
from kit4b_tpu_torch.parallel.swservice import SWJob, SWService
from kit4b_tpu_torch.tools import make_parallel_golden as mg
from torch_parallel_cases import jax_fns

CPU = torch.device("cpu")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def work():
    return {"sw": mg.sw_jobs()}


@pytest.fixture(scope="module")
def jax_out(work):
    return mg.compute(jax_fns(), work, groups=("sw",))


@pytest.fixture(scope="module")
def port_out(work):
    return mg.compute(mg.port_fns("cpu"), work, groups=("sw",))


@pytest.fixture(scope="module")
def golden():
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files if k.startswith("sw:")}


@pytest.mark.parametrize("key", [f"sw:score:D{D}" for D in mg.SW_DS]
                         + ["sw:align:fields", "sw:align:ops"])
def test_swservice_matches_jax_and_golden(jax_out, port_out, golden, key):
    want = golden[key]
    for got in (jax_out[key], port_out[key]):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def _batch(jobs):
    B = len(jobs)
    Lp = max(len(p) for p, _, _ in jobs)
    Lt = max(len(t) for _, t, _ in jobs)
    probes = np.full((B, Lp), 0x0F, np.uint8)
    targets = np.full((B, Lt), 0x0F, np.uint8)
    for i, (p, t, _) in enumerate(jobs):
        probes[i, :len(p)] = p
        targets[i, :len(t)] = t
    return (probes, np.array([len(p) for p, _, _ in jobs], np.int32),
            targets, np.array([len(t) for _, t, _ in jobs], np.int32),
            np.array([d for _, _, d in jobs], np.int32))


def test_score_and_align_equal_banded_sw_batch(work, port_out):
    jobs = work["sw"]
    full = banded_sw_batch(*_batch(jobs), band=mg.SW_BAND, device=CPU)
    scan = banded_sw_batch(*_batch(jobs), band=mg.SW_BAND, device=CPU,
                           traceback=False)
    assert [a.score for a in scan] == [a.score for a in full]
    for D in mg.SW_DS:
        assert port_out[f"sw:score:D{D}"].tolist() == [a.score for a in full]
    got = SWService(band=mg.SW_BAND, devices=[CPU]).align(
        [SWJob(p, t, d) for p, t, d in jobs])
    assert got == full
    ops = port_out["sw:align:ops"].tolist()
    assert any("D" in o for o in ops) and any(s < 50 for s in
                                              port_out["sw:score:D1"])


def test_empty_and_odd_batches():
    svc = SWService(band=32, scores=SWScores(), devices=[CPU] * 4)
    assert svc.score([]).shape == (0,) and svc.align([]) == []
    rng = np.random.default_rng(5)
    jobs = [SWJob(a, a.copy(), 0) for a in
            (rng.integers(0, 4, n).astype(np.uint8) for n in (50, 60, 70))]
    assert svc.score(jobs).tolist() == [50, 60, 70]     # 3 jobs on 4 shards


def test_default_devices_need_cuda(monkeypatch):
    from kit4b_tpu_torch.device import DeviceUnavailable
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        SWService()


# --- distributed ------------------------------------------------------------

def test_distributed_helpers(tmp_path):
    """tests/test_parallel.py's `test_distributed_helpers`, on both
    packages."""
    assert dist.initialize() == (0, 1) == jdist.initialize()
    items = list(range(10))
    for mod in (dist, jdist):
        assert list(mod.host_shard(items, 1, 3)) == [1, 4, 7]
        assert list(mod.host_shard(items, 0, 1)) == items
        assert list(mod.host_shard(items)) == items
        assert mod.shard_output_path("o.sam", 0).endswith("o.sam")
        assert mod.shard_output_path("o.sam", 3) == "o.p3.sam"
        assert mod.shard_output_path("d/o.sam") == "d/o.sam"
    a, b = tmp_path / "a.sam", tmp_path / "b.sam"
    a.write_text("@HD\tVN:1.4\nr1\t0\tc\t1\t0\t*\t*\t0\t0\tA\t*\n")
    b.write_text("@HD\tVN:1.4\nr2\t0\tc\t2\t0\t*\t*\t0\t0\tA\t*\n")
    for mod, out in ((dist, tmp_path / "m.sam"), (jdist, tmp_path / "j.sam")):
        mod.merge_sam_shards(out, [a, b])
    lines = (tmp_path / "m.sam").read_text().splitlines()
    assert sum(1 for line in lines if line.startswith("@")) == 1
    assert len(lines) == 3
    assert (tmp_path / "m.sam").read_bytes() == (tmp_path / "j.sam") \
        .read_bytes()
    m = dist.global_mesh(("dp", "tp"), (4, 2), devices=[CPU] * 8)
    assert m.devices.shape == (4, 2) and m.axis_names == ("dp", "tp")
    assert dist.global_mesh(devices=[CPU] * 3).devices.shape == (3, 1)
    with pytest.raises(ValueError, match="need 9 devices, have 8"):
        dist.global_mesh(shape=(3, 3), devices=[CPU] * 8)


WORKER = textwrap.dedent("""
    import sys
    sys.modules['jax'] = None
    sys.modules['kit4b_tpu'] = None
    sys.path.insert(0, {repo!r})
    from pathlib import Path
    import torch.distributed as td
    from kit4b_tpu_torch.parallel import distributed as dist

    rank, tmp, n = int(sys.argv[1]), Path(sys.argv[2]), int(sys.argv[3])
    kw = dict(init_method=f"file://{{tmp}}/group") if n > 1 else {{}}
    assert dist.initialize(None, n, rank, **kw) == (rank, n)
    assert dist.initialize() == (rank, n)      # the group already exists
    out = dist.shard_output_path(tmp / "out.sam")
    records = [f"r{{i}}\\t0\\tc\\t{{i + 1}}\\t60\\t4M\\t*\\t0\\t0\\tACGT\\t*"
               for i in range(11)]
    with open(out, "w") as f:
        f.write("@HD\\tVN:1.4\\n@SQ\\tSN:c\\tLN:100\\n")
        for rec in dist.host_shard(records):
            f.write(rec + "\\n")
    if n > 1:
        td.barrier()
        if rank == 0:
            dist.merge_sam_shards(
                tmp / "merged.sam",
                [dist.shard_output_path(tmp / "out.sam", r)
                 for r in range(n)])
        td.barrier()
        td.destroy_process_group()
    print("rank", rank, "wrote", out)
""")


def test_two_gloo_processes_merge_to_the_one_process_output(tmp_path):
    script = tmp_path / "worker.py"
    script.write_text(WORKER.format(repo=str(REPO)))
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    r = subprocess.run([sys.executable, str(script), "0", str(one), "1"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    procs = [subprocess.Popen([sys.executable, str(script), str(rank),
                               str(two), "2"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in (0, 1)]
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-2000:]
    assert sorted(q.name for q in two.glob("out*.sam")) == \
        ["out.p0.sam", "out.p1.sam"]
    p0 = (two / "out.p0.sam").read_text().splitlines()
    assert [x.split("\t")[0] for x in p0 if not x.startswith("@")] == \
        ["r0", "r2", "r4", "r6", "r8", "r10"]
    merged = (two / "merged.sam").read_text().splitlines()
    want = (one / "out.sam").read_text().splitlines()
    assert [x for x in merged if x.startswith("@")] == \
        [x for x in want if x.startswith("@")]
    assert sorted(x for x in merged if not x.startswith("@")) == \
        sorted(x for x in want if not x.startswith("@"))
