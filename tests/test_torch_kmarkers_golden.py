"""The committed kmarkers golden (kit4b_tpu_torch/data/kmarkers_golden.npz),
which phases 9a and 10a of chip_smoke.py hold the port to on the card:
regenerated here through the JAX package it must equal the committed file,
so it cannot rot; and the port on the CPU must equal it too.

Run as a script from the root of the repository, this file writes the
golden anew (JAX on the CPU):

    python tests/test_torch_kmarkers_golden.py [-o PATH]
"""
import argparse
import os
import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from kit4b_tpu_torch import native  # noqa: E402
from kit4b_tpu_torch.kmer.kmarkers import core_offsets  # noqa: E402
from kit4b_tpu_torch.tools import make_kmarkers_golden as mg  # noqa: E402
from test_torch_kmarkers_card import few_threads  # noqa: E402,F401



def jax_fns():
    """The callables of compute_kmarkers() and compute_restricted()
    through the JAX package: its own Genome and
    SfxIndex of the workload, its kmarkers pass and its restricted
    hammings. The positions run in each tier are read off the pass's own
    calls: a position's code does not depend on its batch, and padding
    repeats a real position of the same tier."""
    import jax.numpy as jnp

    from kit4b_tpu.index.sfx_index import SfxIndex
    from kit4b_tpu.io.fasta import Genome
    from kit4b_tpu.kmer import hammings, kmarkers

    def jax_genome(pg):
        return Genome(list(pg.names), pg.starts, pg.lengths, pg.seq)
    pg, _, cc, _ = mg.workload()
    g = jax_genome(pg)
    idx = SfxIndex.build(g)
    kpass = kmarkers._kmarkers_pass_factory()

    def find_markers(mh, extend):
        seen = {}       # n_compact -> {position: code}

        def spy(*args, n_compact, **kw):
            codes = kpass(*args, n_compact=n_compact, **kw)
            seen.setdefault(n_compact, {}).update(
                zip(np.asarray(args[6]).tolist(), np.asarray(codes).tolist()))
            return codes
        kmarkers._KMARKERS_PASS = spy
        try:
            markers = kmarkers.find_cultivar_markers(
                idx, cc, mg.TARGET, kmer_len=mg.K, min_hamming=mh,
                batch=mg.BATCH, extend=extend)
        finally:
            kmarkers._KMARKERS_PASS = None
        t3 = seen.get(2048, {})
        return markers, {"tier1": len(seen[24]),
                         "tier2": len(seen.get(256, {})),
                         "tier3": len(t3),
                         "dropped": sum(c >= 2 for c in t3.values())}

    gview, sa, lut = kmarkers._fast_device_arrays(idx, mg.K)
    dev = [jnp.asarray(a) for a in (g.seq, g.starts.astype(np.int32), cc)]

    def pass_codes(mh, qp):
        return np.asarray(kpass(
            gview, sa, lut, *dev, jnp.asarray(qp), K=mg.K,
            genome_len=len(g.seq), offsets=core_offsets(mg.K, mh, idx.lut_k),
            lut_k=idx.lut_k,
            n_compact=24, max_ml=48, min_hamming=mh, target=mg.TARGET))

    def restricted(rg, lut_k, k, mh, batch):
        return hammings.hammings_restricted(
            SfxIndex.build(jax_genome(rg), lut_k), k, max_hamming=mh,
            batch=batch)
    return find_markers, pass_codes, kmarkers.write_markers_fasta, restricted


def compute(find_markers, pass_codes, write_markers_fasta, restricted):
    return mg.compute_kmarkers(find_markers, pass_codes, write_markers_fasta) \
        | mg.compute_restricted(restricted)


def jax_golden() -> dict:
    out = compute(*jax_fns())
    out["inputs_sha256"] = np.array(mg.inputs_sha256())
    return out


def check_reach(out) -> list[str]:
    """What the workload must exercise, as messages for what it misses."""
    bad = []
    for mh in mg.MIN_HAMMINGS:
        t1, t2, t3, dropped = out[f"tiers_e{mh}"]
        if not (t2 > 0 and t3 > 0 and dropped > 0):
            bad.append(f"min_hamming {mh}: tiers {out[f'tiers_e{mh}']}")
        if not len(out[f"markers_m1_e{mh}"]):
            bad.append(f"min_hamming {mh}: no markers")
    if len({out[f"codes_e{mh}"].tobytes() for mh in mg.MIN_HAMMINGS}) < 3:
        bad.append("min_hamming does not change the pass codes")
    return bad


@pytest.fixture(scope="module")
def golden():
    try:
        native.load()
    except native.NativeUnavailable as e:
        pytest.skip(f"native library unavailable: {e}")
    with np.load(mg.GOLDEN) as z:
        return {k: z[k] for k in z.files}


def test_golden_regenerates_through_jax(golden):
    out = jax_golden()
    assert sorted(out) == sorted(golden)
    for key, want in golden.items():
        np.testing.assert_array_equal(out[key], want, err_msg=key)
    # it exercises what phase 9a is there to hold: both escalation tiers,
    # the last tier's survivors dropped, codes 0, 1 and 2
    assert check_reach(golden) == []
    assert set(np.unique(golden["codes_e2"])) == {0, 1, 2}


def test_port_on_cpu_matches_golden(golden):
    assert mg.inputs_sha256() == str(golden["inputs_sha256"])
    out = compute(*mg.port_fns("cpu"))
    for key in golden:
        if key != "inputs_sha256":
            np.testing.assert_array_equal(out[key], golden[key],
                                          err_msg=key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Write the kmarkers golden through the JAX package.")
    ap.add_argument("-o", "--out", default=str(mg.GOLDEN))
    args = ap.parse_args(argv)
    out = jax_golden()
    if check_reach(out):
        raise SystemExit(f"the workload misses: {check_reach(out)}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(args.out, **out)
    for mh in mg.MIN_HAMMINGS:
        print(f"min_hamming {mh}: tiers {out[f'tiers_e{mh}'].tolist()}, "
              f"markers {len(out[f'markers_m0_e{mh}'])} / "
              f"{len(out[f'markers_m1_e{mh}'])} (-m 0 / -m 1)")
    print(f"{args.out}: restricted minima "
          f"{[int(out[k].min()) for k in out if k.startswith('restricted')]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
