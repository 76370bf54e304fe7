"""The minmm roofline's count: the bound a strand at each cell's shape, no
higher than the floor of any exact method the card offers, and the premise
that makes the 2:4-sparse rate the one to count, that the program's one-hot
rows hold at most 2 ones in every aligned group of 4 channels."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kbench import roofline, run
from kbench.reference.hammings import node_columns
from conftest import load_bench

CARD = "NVIDIA H100 80GB HBM3"
# ms a strand at the cell's shape: 2:4-sparse over 64-channel steps
BOUND_MS = {"hammings.yeast_r64.k25_node1of4": 2356.45,
            "hammings.grch38.k25_node2849of4096": 817.83}


def _shape(name: str) -> dict:
    """rows, cols and K of one strand's product in cell `name`, from its
    configuration and traffic files, without making the genome."""
    _, config, traffic = run.cell_spec(load_bench(), name)
    lengths = config["genome"]["lengths"]
    G = sum(lengths) + len(lengths)      # the codes and a separator each
    K, node = int(config["K"]), int(traffic["node"]) - 1
    if traffic["job"] == "hammings_node":
        s = roofline.hammings_node_shape(G, K, node, int(traffic["numnodes"]),
                                         bool(config["antisense"]))
        return {k: s[k] for k in ("rows", "cols", "K")}
    _, c0, c1 = node_columns(G, node, int(traffic["numnodes"]))
    return {"rows": int(traffic["unit_rows"]), "cols": c1 - c0, "K": K}


@pytest.mark.parametrize("name", BOUND_MS)
def test_bound_a_strand_at_each_cells_shape(name):
    s = _shape(name)
    t = roofline.minmm_bound_s(s["rows"], s["cols"], s["K"], CARD)
    assert round(t * 1e3, 2) == BOUND_MS[name]
    dense = roofline.peaks(CARD)["int8_ops_per_s"]
    floors = {      # the least time of each exact method on the card
        "dense, 128 channels": roofline.minmm_ops(
            s["rows"], s["cols"], roofline.one_hot_width(s["K"])) / dense,
        "dense, 3 channels a base": roofline.minmm_ops(
            s["rows"], s["cols"], -(-3 * s["K"] // 32) * 32) / dense,
        "2:4-sparse, 5 channels a base": roofline.minmm_ops(
            s["rows"], s["cols"], roofline.sparse_channels(s["K"]))
        / roofline.peaks(CARD)["int8_sparse_ops_per_s"],
    }
    assert all(t <= f for f in floors.values()), floors
    assert t == floors["2:4-sparse, 5 channels a base"]   # not the bytes
    assert t * 2 == pytest.approx(floors["dense, 128 channels"])


def _codes(K: int, n: int, seed: int) -> np.ndarray:
    """n + K - 1 codes of one strand: bases, N runs and separators."""
    rng = np.random.default_rng(seed)
    c = rng.integers(0, 4, n + K - 1).astype(np.uint8)
    c[5:5 + K + 3] = 4                           # an N run past a window
    c[n // 2:n // 2 + 2 * K] = 4
    c[n // 3] = 7                                # a chromosome separator
    c[2 * n // 3:2 * n // 3 + 3] = 15            # end-of-genome codes
    return c


@pytest.mark.parametrize("j0", [0, 2**31 + 37])
@pytest.mark.parametrize("K", [7, 13, 25, 31])
def test_onehot_windows_are_2_to_4_sparse(K, j0):
    from kit4b_tpu_torch.kmer.hammings_mxu import onehot_windows
    n = 640
    G = j0 + n - 40          # the last rows start past G - K + 1
    codes = _codes(K, n, seed=K)
    W, valid = onehot_windows(torch.from_numpy(codes), j0, n, K=K, G=G)
    W, valid = W.numpy(), valid.numpy()
    assert W.shape[1] == roofline.one_hot_width(K)
    assert W.shape[1] % 4 == 0 and set(np.unique(W)) <= {0, 1}
    assert not W[:, 5 * K:].any()                # padding channels zero
    groups = W.reshape(n, -1, 4).sum(2)
    assert groups.max() == 2                     # 2:4, and not 1:4
    # the sparse count takes all of 5K, padded to the sparse k-step
    assert roofline.sparse_channels(K) % roofline.SPARSE_K_STEP == 0
    assert 5 * K <= roofline.sparse_channels(K) <= W.shape[1]
    # the inputs reach every kind of row: valid, N only, separator, past G
    ends = np.arange(n) + j0 > G - K
    assert valid.any() and ends.any() and not valid[ends].any()
    assert (W.sum(1) == np.where(valid, K, 0)).all()
    has_sep = np.array([(codes[i:i + K] >= 5).any() for i in range(n)])
    assert has_sep.any() and not valid[has_sep].any()
    all_n = np.array([(codes[i:i + K] == 4).all() for i in range(n)])
    assert all_n.any() and valid[all_n & ~ends].all()
