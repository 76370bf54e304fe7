"""`hammings -M` and `-R` on the CPU: the port's row-sharded
(`parallel/hammings_mesh.py`) and ring (`parallel/hammings_ring.py`)
engines on `[cpu] * D` against the JAX package's on `jax.devices()[:D]`
(its XLA branch) and the committed golden, exactly, at D 1, 2, 4 and 8 on
`make_parallel_golden.hammings_cases()` (an N run and leading Ns, an EOS,
exact repeats across blocks, 30 bp under K 25; K 6, 8, 13 and 25, both
strands and sense only; node partitions of the mesh); against the port's
single-device engine and the numpy oracle; and the early returns of
both engines. The CLI's bytes are in tests/test_torch_cli.py."""
import jax
import numpy as np
import pytest
import torch

from kit4b_tpu.parallel.hammings_mesh import hammings_mesh as jax_mesh
from kit4b_tpu.parallel.hammings_ring import hammings_ring as jax_ring
from kit4b_tpu_torch.kernels.minmm import minmm
from kit4b_tpu_torch.kmer.hammings import hammings_oracle
from kit4b_tpu_torch.kmer.hammings_mxu import hammings_exhaustive_mxu
from kit4b_tpu_torch.parallel.hammings_mesh import hammings_mesh
from kit4b_tpu_torch.parallel.hammings_ring import hammings_ring
from kit4b_tpu_torch.tools import make_parallel_golden as mg
from torch_parallel_cases import jax_fns

CPU = torch.device("cpu")
GROUPS = ("mesh", "ring")
CASES = {c[0]: c for c in mg.hammings_cases()}


@pytest.fixture(scope="module")
def work():
    return {"ham": mg.hammings_cases()}


@pytest.fixture(scope="module")
def jax_out(work):
    return mg.compute(jax_fns(), work, groups=GROUPS)


@pytest.fixture(scope="module")
def port_out(work):
    launches = minmm.launches
    out = mg.compute(mg.port_fns("cpu"), work, groups=GROUPS)
    assert minmm.launches == launches      # the CPU runs the plain version
    return out


@pytest.fixture(scope="module")
def golden():
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files if k.split(":")[0] in GROUPS}


def _keys():
    keys = []
    for name, _, _, _, _, _, Ds, nodes in mg.hammings_cases():
        for engine in GROUPS:
            keys += [f"{engine}:{name}:D{D}" for D in Ds]
        if nodes > 1:
            keys += [f"mesh:{name}:D4:N{n + 1}of{nodes}"
                     for n in range(nodes)]
    return keys


@pytest.mark.parametrize("key", _keys())
def test_engine_matches_jax_and_golden(jax_out, port_out, golden, key):
    want = golden[key]
    assert want.dtype == np.uint16
    for got in (jax_out[key], port_out[key]):
        assert got.dtype == np.uint16 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_golden_has_no_other_keys(golden):
    assert sorted(golden) == sorted(_keys())


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_d_equals_the_single_device_engine(port_out, name):
    """Over every node's spans (-n 1) both engines give the single-device
    engine's answer, whatever D and the geometry."""
    _, codes, K, anti, _, _, Ds, _ = CASES[name]
    want = hammings_exhaustive_mxu(codes, K, antisense=anti, device=CPU)
    for engine in GROUPS:
        for D in Ds:
            np.testing.assert_array_equal(port_out[f"{engine}:{name}:D{D}"],
                                          want, err_msg=f"{engine} D={D}")


@pytest.mark.parametrize("name", ["eos8", "sense6"])
def test_engines_equal_the_oracle(port_out, name):
    _, codes, K, anti, *_ = CASES[name]
    n = len(codes) - K + 1
    want = hammings_oracle(codes, K, antisense=anti)
    for engine in GROUPS:
        got = port_out[f"{engine}:{name}:D2"]
        np.testing.assert_array_equal(got[:n].astype(int),
                                      want[:n].astype(int))


@pytest.mark.parametrize("engine", GROUPS)
def test_planted_copies_read_zero_on_every_d(port_out, engine):
    K = CASES["repeat8"][2]
    for D in mg.HAM_DS:
        got = port_out[f"{engine}:repeat8:D{D}"]
        assert (got[100:300 - K + 1] == 0).all()
        assert (got[1600:1800 - K + 1] == 0).all()


def test_node_partitions_merge_to_the_whole(port_out):
    """The node results of `-M -n 3` merge (elementwise min) to the
    mesh's -n 1 result."""
    parts = [port_out[f"mesh:nrun13:D4:N{n}of3"] for n in (1, 2, 3)]
    np.testing.assert_array_equal(np.minimum.reduce(parts),
                                  port_out["mesh:nrun13:D4"])


@pytest.mark.parametrize("codes,K,anti", [
    (np.zeros(0, np.uint8), 5, True),                  # empty genome
    (np.arange(10, dtype=np.uint8) % 4, 25, True),     # G < K
    (np.full(200, 4, np.uint8), 8, True),              # Ns only: valid
    (np.full(300, 7, np.uint8), 8, True),              # EOS only: no window
    (np.concatenate([np.zeros(8, np.uint8), np.full(100, 7, np.uint8)]),
     8, False),                                        # one sense window
])
@pytest.mark.parametrize("engine", GROUPS)
def test_early_returns_match_jax(engine, codes, K, anti):
    port, jx = (hammings_mesh, jax_mesh) if engine == "mesh" \
        else (hammings_ring, jax_ring)
    for D in (1, 2):
        got = port(codes, K, antisense=anti, devices=[CPU] * D)
        want = jx(codes, K, antisense=anti, devices=jax.devices()[:D],
                  use_pallas=False)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_node_past_the_spans_returns_no_distance():
    g = mg.ring_genome(300, with_n=False)
    got = hammings_mesh(g, 8, devices=[CPU], node=5, numnodes=8)
    want = jax_mesh(g, 8, devices=jax.devices()[:1], node=5, numnodes=8,
                    use_pallas=False)
    np.testing.assert_array_equal(got, want)
    assert (got == 0xFFFF).all()
